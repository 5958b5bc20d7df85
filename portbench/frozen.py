"""The program's arithmetic the benchmark measures by, frozen here so that
no later change to the program moves the yardstick. Each function names
the file and line it was copied from; where the copy departs, it says so.
"""

from __future__ import annotations

# Published dense peaks of each card by torch.cuda.get_device_name(), at
# its full power limit (NVIDIA's H100 SXM data sheet; copied from
# tpu_dra_torch/native/gpuinfo.py:56-67). A card not listed gives no
# roofline or utilization share.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def bounds(b, s, h, d, peak_flops, peak_bytes, elem=2) -> dict:
    """Least time for the work of one attention call at this shape: the
    larger of its tensor-core FLOPs (causal pairs only) over `peak_flops`
    and its compulsory bytes (each input read once, each output written
    once, in elements of `elem` bytes) over the memory rate.

    Copied from chip_smoke.py:875-904 (``bounds``). It counts the work of
    the call from its shape, whatever kernels carry it."""
    pairs = b * h * s * (s + 1) // 2
    tile = b * s * h * d * elem       # one [B, S, H, D] operand
    row = b * h * s * 4               # one fp32 [B, H, S] row vector
    tables = 2 * s * d * elem         # cos and sinm, in the input type
    work = {
        # q, k, v in; o, lse out. QK^T and PV.
        "flash_fwd": (4 * d * pairs, 4 * tile + row + tables),
        # The fused backward: q, k, v, dO, lse, delta, dlse in; dq, dk, dv
        # out. QK^T, dO V^T, P^T dO, dS^T Q, dS K.
        "flash_bwd": (10 * d * pairs, 7 * tile + 3 * row + tables),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
        out[name] = {
            "flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
    return out


def flops_per_token(vocab, d_model, n_layers, max_seq, n_params):
    """(flops_per_token, matmul_params) of the dense TransformerLM: 6 x the
    matmul-participating params (every param but the input embedding
    table, whose forward is a gather) plus causal attention's score and
    value matmuls, 6*L*S*D per token.

    Copied from tpu_dra_torch/bench.py:146-157 (``_flops_per_token``),
    with the config's fields passed one by one."""
    matmul_params = n_params - vocab * d_model
    return (6 * matmul_params + 6 * n_layers * max_seq * d_model), matmul_params


def category(kernel: str) -> str:
    """The kernel-name category of a device event.

    Copied from tpu_dra_torch/bench.py:482-490 (``_category``): "flash_"
    matches the port's attention kernels (flash_fwd_sm90_kernel,
    flash_bwd_sm90_kernel, flash_bwd_dq_epilogue, and the mma route's
    flash_fwd_kernel, flash_bwd_mma_kernel); "nvjet", "gemm", "xmma" and
    "cutlass" match cuBLAS's GEMMs."""
    name = kernel.lower()
    if "flash_" in name:
        return "flash attention (port kernels)"
    if any(tag in name for tag in ("nvjet", "gemm", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    if "copy_kernel" in name:
        return "dtype casts and copies"
    return "other elementwise and reductions"


ATTENTION = "flash attention (port kernels)"
GEMM = "matmul (cuBLAS)"
