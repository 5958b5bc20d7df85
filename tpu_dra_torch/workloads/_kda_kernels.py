"""Launch Kimi Delta Attention's chunk kernels (csrc/kda_chunk.cu).

The function, per (batch, head), over tokens t = 0..T-1 with q_t, k_t
(dk wide), v_t (dv wide), a per-channel log-decay g_t (dk wide, <= 0)
and a scalar beta_t, from S_0 = 0:

    S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T
    o_t = S_t^T q_t

computed in chunks of C = 64 tokens (the WY form of the gated delta
rule with a per-channel decay). Within a chunk, with G the inclusive
cumulative sum of g over the chunk's rows and S the state before it:

- A~[r, i] = sum_c k_rc k_ic exp(G_rc - G_ic) (i < r) and P[r, i] =
  sum_c q_rc k_ic exp(G_rc - G_ic) (i <= r), each pair's decay taken
  channel by channel: exp of a difference that is never positive, so
  no factor overflows whatever the decays (exp(G) alone would, past
  ~88 nats a chunk, which strong decays reach in a few tokens);
- M = I + Diag(beta) A~ (unit lower triangular); W = M^-1 Diag(beta)
  (k * exp G) and U~ = M^-1 Diag(beta) v, by forward substitution;
- U = U~ - W S; o = (q * exp G) S + P U; the next state is
  Diag(exp G_last) S + Kh^T U with Kh = k * exp(G_last - G).

The backward recomputes the chunks' states (never kept from the
forward), runs the state's gradient back over the chunks, and then
works out each chunk's gradients from its own rows alone.

Five C entry points, each with its plain PyTorch version beside it; the
plain versions follow the kernels stage by stage in fp32:

- ``intra`` (``kda_intra``): per chunk W, U~, q exp G, Kh, P, exp G_last
  and (for the backward) A~. Parallel over (chunk, head, batch).
- ``state_fwd`` (``kda_state_fwd``): the state pass over the chunks in
  order, per (batch, head, 32 columns of dv): o, or (for the backward)
  each chunk's starting state and U.
- ``state_bwd`` (``kda_state_bwd``): the state's gradient over the
  chunks in reverse: each chunk's dS (of its end state) and dU.
- ``dstate`` (``kda_dstate``): per chunk the gradients of q exp G, W,
  Kh, P and exp G_last from its states and rows.
- ``intra_bwd`` (``kda_intra_bwd``): per chunk, back through the
  substitution, the pairs' decays and the cumulative sum: dq, dk, dv,
  dg, dbeta.

``chunk_fwd`` and ``chunk_bwd`` run the forward's two and the
backward's six launches. q, k, v (bf16 on a card) are [B, T, H, D]
with dk = dv = 128, g fp32 [B, T, H, dk] and beta fp32 [B, T, H]. The
source's header says what bounds the kernels on the H100 and what their
design does about it; they replace no TPU kernel (the JAX package has
no linear attention). _cuda.py builds, loads and launches them; this
module declares the source's entry points there. For CPU tensors the
wrappers run the plain versions; for CUDA tensors they launch the
kernels on the current stream or raise. There is no other path.
"""

from __future__ import annotations

import torch

from tpu_dra_torch.workloads import _cuda

CHUNK = 64
KERNEL_DIMS = (128, 128)          # (dk, dv) the kernels take
KERNEL_DTYPE = torch.bfloat16
DV_BLOCK = 32                     # dv columns of one state-pass CTA

_PTR, _INT = _cuda.PTR, _cuda.INT
# The C entry points of csrc/kda_chunk.cu; each takes B, T, H and the
# stream last. Chunk buffers are fp32 [B, H, N, ...], N = ceil(T / 64).
ARGTYPES = {
    # q, k, v, g, beta; W, U~, Qg, Kh, P, glast, A~ (may be null).
    "kda_intra": [_PTR] * 12 + [_INT] * 3 + [_PTR],
    # W, U~, Qg, Kh, P, glast; o, S0s, U (each may be null).
    "kda_state_fwd": [_PTR] * 9 + [_INT] * 3 + [_PTR],
    # Qg, W, Kh, P, glast, do; dSs, dU.
    "kda_state_bwd": [_PTR] * 8 + [_INT] * 3 + [_PTR],
    # do, U, dU, S0s, dSs; dQg, dW, dKh, dP, dglast.
    "kda_dstate": [_PTR] * 10 + [_INT] * 3 + [_PTR],
    # q, k, v, g, beta, A~, W, U~, dQg, dW, dU, dKh, dP, dglast; dq, dk,
    # dv, dg, dbeta.
    "kda_intra_bwd": [_PTR] * 19 + [_INT] * 3 + [_PTR],
}
_cuda.declare({"kda_chunk": ARGTYPES})


def n_chunks(t: int) -> int:
    return -(-t // CHUNK)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (fp32, chunk-major [B, H, N, C, ...])
# ---------------------------------------------------------------------------

def to_chunks(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, ...] -> fp32 [B, H, N, C, ...], rows past T zero."""
    b, t, h = x.shape[:3]
    n = n_chunks(t)
    x = x.float()
    if n * CHUNK > t:
        x = torch.cat([x, x.new_zeros((b, n * CHUNK - t) + x.shape[2:])], 1)
    x = x.view(b, n, CHUNK, h, *x.shape[3:])
    return x.permute(0, 3, 1, 2, *range(4, x.dim())).contiguous()


def from_chunks(x: torch.Tensor, t: int) -> torch.Tensor:
    """fp32 [B, H, N, C, ...] -> [B, T, H, ...]."""
    b, h, n, c = x.shape[:4]
    x = x.permute(0, 2, 3, 1, *range(4, x.dim())).reshape(b, n * c, h,
                                                          *x.shape[4:])
    return x[:, :t]


def _pairs(a, b, G, r):
    """sum_c a[r, c] b[i, c] exp(G[r, c] - G[i, c]) for i <= r, and the
    per-pair factors b[i] exp(G[r] - G[i]) [..., r + 1, dk]."""
    e = torch.exp(G[..., r:r + 1, :] - G[..., :r + 1, :]) * b[..., :r + 1, :]
    return (a[..., r:r + 1, :] * e).sum(-1), e


def intra_plain(q, k, v, g, beta):
    """The chunk-local quantities of kda_intra, from chunked fp32 q, k
    [.., C, dk], v [.., C, dv], g [.., C, dk] and beta [.., C]: {"W",
    "Ut", "Qg", "Kh", "P", "glast", "At"}."""
    G = g.cumsum(-2)
    c = q.shape[-2]
    At = q.new_zeros(q.shape[:-1] + (c,))
    P = q.new_zeros(q.shape[:-1] + (c,))
    for r in range(c):
        P[..., r, :r + 1], e = _pairs(q, k, G, r)
        At[..., r, :r] = (k[..., r:r + 1, :] * e[..., :r, :]).sum(-1)
    eye = torch.eye(c, dtype=q.dtype, device=q.device)
    M = eye + beta[..., :, None] * At
    Kg = k * torch.exp(G)
    W = torch.linalg.solve_triangular(M, beta[..., None] * Kg, upper=False,
                                      unitriangular=True)
    Ut = torch.linalg.solve_triangular(M, beta[..., None] * v, upper=False,
                                       unitriangular=True)
    return {"W": W, "Ut": Ut, "Qg": q * torch.exp(G),
            "Kh": k * torch.exp(G[..., -1:, :] - G), "P": P,
            "glast": torch.exp(G[..., -1, :]), "At": At}


def state_fwd_plain(W, Ut, Qg, Kh, P, glast):
    """kda_state_fwd over chunked fp32 tensors: (o [.., N, C, dv], the
    state before each chunk [.., N, dk, dv], U [.., N, C, dv])."""
    n = W.shape[-3]
    S = W.new_zeros(W.shape[:-3] + (W.shape[-1], Ut.shape[-1]))
    O, S0s, U = torch.empty_like(Ut), [], torch.empty_like(Ut)
    for j in range(n):
        S0s.append(S)
        U[..., j, :, :] = Ut[..., j, :, :] - W[..., j, :, :] @ S
        O[..., j, :, :] = Qg[..., j, :, :] @ S + P[..., j, :, :] @ U[..., j, :, :]
        S = (glast[..., j, :, None] * S
             + Kh[..., j, :, :].transpose(-1, -2) @ U[..., j, :, :])
    return O, torch.stack(S0s, -3), U


def state_bwd_plain(Qg, W, Kh, P, glast, dO):
    """kda_state_bwd: (the gradient of each chunk's end state [.., N, dk,
    dv], dU [.., N, C, dv]) from dO [.., N, C, dv]."""
    n = W.shape[-3]
    dS = W.new_zeros(W.shape[:-3] + (W.shape[-1], dO.shape[-1]))
    dSs, dU = [None] * n, torch.empty_like(dO)
    for j in reversed(range(n)):
        dSs[j] = dS
        dU[..., j, :, :] = (Kh[..., j, :, :] @ dS
                            + P[..., j, :, :].transpose(-1, -2) @ dO[..., j, :, :])
        dS = (glast[..., j, :, None] * dS
              + Qg[..., j, :, :].transpose(-1, -2) @ dO[..., j, :, :]
              - W[..., j, :, :].transpose(-1, -2) @ dU[..., j, :, :])
    return torch.stack(dSs, -3), dU


def dstate_plain(dO, U, dU, S0s, dSs):
    """kda_dstate: (dQg, dW, dKh, dP, dglast) of each chunk."""
    dP = torch.tril(dO @ U.transpose(-1, -2))
    return (dO @ S0s.transpose(-1, -2), -dU @ S0s.transpose(-1, -2),
            U @ dSs.transpose(-1, -2), dP, (dSs * S0s).sum(-1))


def intra_bwd_plain(q, k, v, g, beta, At, W, Ut, dQg, dW, dU, dKh, dP,
                    dglast):
    """kda_intra_bwd: (dq, dk, dv, dg, dbeta) of each chunk's rows, from
    its inputs, A~, W and U~ (kda_intra's) and the gradients of W, U~
    (= dU), Qg, Kh, P and glast."""
    c = q.shape[-2]
    G = g.cumsum(-2)
    eG = torch.exp(G)
    Kg = k * eG
    eye = torch.eye(c, dtype=q.dtype, device=q.device)
    MT = (eye + beta[..., :, None] * At).transpose(-1, -2)
    dX = torch.linalg.solve_triangular(MT, dW, upper=True, unitriangular=True)
    dY = torch.linalg.solve_triangular(MT, dU, upper=True, unitriangular=True)
    dA = -torch.tril(dX @ W.transpose(-1, -2) + dY @ Ut.transpose(-1, -2), -1)
    dAt = beta[..., :, None] * dA
    dbeta = ((dA * At).sum(-1) + (dX * Kg).sum(-1) + (dY * v).sum(-1))
    dv = beta[..., None] * dY
    dKg = beta[..., None] * dX
    Kh = k * torch.exp(G[..., -1:, :] - G)
    dk = dKg * eG + dKh * torch.exp(G[..., -1:, :] - G)
    dq = dQg * eG
    dG = dKg * Kg + dQg * q * eG - dKh * Kh
    dG[..., -1, :] += (dKh * Kh).sum(-2) + dglast * eG[..., -1, :]
    col = torch.zeros_like(k)
    for r in range(c):
        _, e = _pairs(q, k, G, r)              # k_i exp(G_r - G_i), i <= r
        tk = (dAt[..., r, :r + 1, None] * e).sum(-2)
        tq = (dP[..., r, :r + 1, None] * e).sum(-2)
        dk[..., r, :] += tk
        dq[..., r, :] += tq
        dG[..., r, :] += k[..., r, :] * tk + q[..., r, :] * tq
        f = torch.exp(G[..., r:r + 1, :] - G[..., :r + 1, :])
        col[..., :r + 1, :] += (dAt[..., r, :r + 1, None] * k[..., r:r + 1, :]
                                + dP[..., r, :r + 1, None] * q[..., r:r + 1, :]) * f
    dk = dk + col
    dG = dG - k * col
    dg = dG.flip(-2).cumsum(-2).flip(-2)
    return dq, dk, dv, dg, dbeta


def chunk_fwd_plain(q, k, v, g, beta):
    """o [B, T, H, dv] in q's dtype, by the chunk form in fp32."""
    t = q.shape[1]
    parts = intra_plain(*(to_chunks(x) for x in (q, k, v, g, beta)))
    O, _, _ = state_fwd_plain(parts["W"], parts["Ut"], parts["Qg"],
                              parts["Kh"], parts["P"], parts["glast"])
    return from_chunks(O, t).to(q.dtype)


def chunk_bwd_plain(q, k, v, g, beta, do):
    """(dq, dk, dv, dg, dbeta) of sum(o * do), each in its input's
    dtype, by the chunk form's backward in fp32."""
    t = q.shape[1]
    ins = [to_chunks(x) for x in (q, k, v, g, beta)]
    p = intra_plain(*ins)
    _, S0s, U = state_fwd_plain(p["W"], p["Ut"], p["Qg"], p["Kh"], p["P"],
                                p["glast"])
    dO = to_chunks(do)
    dSs, dU = state_bwd_plain(p["Qg"], p["W"], p["Kh"], p["P"], p["glast"],
                              dO)
    dQg, dW, dKh, dP, dglast = dstate_plain(dO, U, dU, S0s, dSs)
    grads = intra_bwd_plain(*ins, p["At"], p["W"], p["Ut"], dQg, dW, dU,
                            dKh, dP, dglast)
    return tuple(from_chunks(d, t).to(x.dtype)
                 for d, x in zip(grads, (q, k, v, g, beta)))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v, g, beta):
    """The inputs as the kernels take them (contiguous), or raise."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    if (dk, dv) != KERNEL_DIMS:
        raise ValueError(f"KDA kernels take (dk, dv) {KERNEL_DIMS}, got "
                         f"{(dk, dv)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != KERNEL_DTYPE:
            raise TypeError(f"KDA kernels take {KERNEL_DTYPE} {name}, got "
                            f"{x.dtype}")
    if k.shape != q.shape or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match")
    if g.shape != q.shape or g.dtype != torch.float32:
        raise ValueError(f"g must be fp32 {tuple(q.shape)}, got {g.dtype} "
                         f"{tuple(g.shape)}")
    if beta.shape != q.shape[:3] or beta.dtype != torch.float32:
        raise ValueError(f"beta must be fp32 {tuple(q.shape[:3])}, got "
                         f"{beta.dtype} {tuple(beta.shape)}")
    return tuple(x.contiguous() for x in (q, k, v, g, beta))


def _buffers(b, h, n, device, **shapes):
    return {name: torch.empty((b, h, n) + shape, dtype=torch.float32,
                              device=device)
            for name, shape in shapes.items()}


def _ptr(x):
    return None if x is None else x.data_ptr()


def _intra(q, k, v, g, beta, with_at: bool):
    b, t, h, dk = q.shape
    n, c = n_chunks(t), CHUNK
    out = _buffers(b, h, n, q.device, W=(c, dk), Ut=(c, dk), Qg=(c, dk),
                   Kh=(c, dk), P=(c, c), glast=(dk,),
                   **({"At": (c, c)} if with_at else {}))
    _cuda.launch("kda_intra", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 g.data_ptr(), beta.data_ptr(), out["W"].data_ptr(),
                 out["Ut"].data_ptr(), out["Qg"].data_ptr(),
                 out["Kh"].data_ptr(), out["P"].data_ptr(),
                 out["glast"].data_ptr(), _ptr(out.get("At")), b, t, h)
    return out


def chunk_fwd(q, k, v, g, beta):
    """o [B, T, H, dv] of the chunked KDA recurrence (in q's dtype)."""
    if _cuda.device_of(q, "KDA") == "cpu":
        return chunk_fwd_plain(q, k, v, g, beta)
    q, k, v, g, beta = _check(q, k, v, g, beta)
    b, t, h, _ = q.shape
    p = _intra(q, k, v, g, beta, with_at=False)
    o = torch.empty_like(v)
    _cuda.launch("kda_state_fwd", q, p["W"].data_ptr(), p["Ut"].data_ptr(),
                 p["Qg"].data_ptr(), p["Kh"].data_ptr(), p["P"].data_ptr(),
                 p["glast"].data_ptr(), o.data_ptr(), None, None, b, t, h)
    return o


def chunk_bwd(q, k, v, g, beta, do):
    """(dq, dk, dv, dg, dbeta) of sum(o * do); dq, dk, dv in q's dtype,
    dg and dbeta fp32."""
    if _cuda.device_of(q, "KDA") == "cpu":
        return chunk_bwd_plain(q, k, v, g, beta, do)
    q, k, v, g, beta = _check(q, k, v, g, beta)
    if do.shape != v.shape:
        raise ValueError(f"do {tuple(do.shape)} for v {tuple(v.shape)}")
    do = do.to(KERNEL_DTYPE).contiguous()
    b, t, h, dk = q.shape
    n, c, dv = n_chunks(t), CHUNK, v.shape[-1]
    p = _intra(q, k, v, g, beta, with_at=True)
    s = _buffers(b, h, n, q.device, S0s=(dk, dv), U=(c, dv), dSs=(dk, dv),
                 dU=(c, dv), dQg=(c, dk), dW=(c, dk), dKh=(c, dk), dP=(c, c),
                 dglast=(dk,))
    _cuda.launch("kda_state_fwd", q, p["W"].data_ptr(), p["Ut"].data_ptr(),
                 p["Qg"].data_ptr(), p["Kh"].data_ptr(), p["P"].data_ptr(),
                 p["glast"].data_ptr(), None, s["S0s"].data_ptr(),
                 s["U"].data_ptr(), b, t, h)
    _cuda.launch("kda_state_bwd", q, p["Qg"].data_ptr(), p["W"].data_ptr(),
                 p["Kh"].data_ptr(), p["P"].data_ptr(), p["glast"].data_ptr(),
                 do.data_ptr(), s["dSs"].data_ptr(), s["dU"].data_ptr(),
                 b, t, h)
    _cuda.launch("kda_dstate", q, do.data_ptr(), s["U"].data_ptr(),
                 s["dU"].data_ptr(), s["S0s"].data_ptr(), s["dSs"].data_ptr(),
                 s["dQg"].data_ptr(), s["dW"].data_ptr(), s["dKh"].data_ptr(),
                 s["dP"].data_ptr(), s["dglast"].data_ptr(), b, t, h)
    dq, dk_, dv_ = (torch.empty_like(x) for x in (q, k, v))
    dg, dbeta = torch.empty_like(g), torch.empty_like(beta)
    _cuda.launch("kda_intra_bwd", q, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), g.data_ptr(), beta.data_ptr(),
                 p["At"].data_ptr(), p["W"].data_ptr(), p["Ut"].data_ptr(),
                 s["dQg"].data_ptr(), s["dW"].data_ptr(), s["dU"].data_ptr(),
                 s["dKh"].data_ptr(), s["dP"].data_ptr(),
                 s["dglast"].data_ptr(), dq.data_ptr(), dk_.data_ptr(),
                 dv_.data_ptr(), dg.data_ptr(), dbeta.data_ptr(), b, t, h)
    return dq, dk_, dv_, dg, dbeta
