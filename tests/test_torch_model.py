"""Port parity: tpu_dra_torch.workloads.model (the flagship TransformerLM),
its entry point and bench against the JAX package, on the CPU, plus the
port's import isolation and its refusal to drop to the CPU unasked.

The reference's own weights are carried across with params_from_jax and
the tokens come from numpy, so both sides compute with the same inputs.
The JAX model runs its flash path in interpret mode ("flash_interpret"),
the port its kernels' plain versions ("flash").

Tolerances:
- fp32: logits, loss and every gradient leaf within 1e-4 relative (max
  |diff| / max |ref|): the same fp32 function summed in different orders
  through two layers and a backward pass.
- bf16: logits relative norm <= 1e-2 and gradient leaves max-rel <=
  5e-2, the reference's own kernel-vs-reference bounds
  (tests/test_flashattention.py TestModelParity): bf16 rounding at
  different points dominates the smallest leaves (the rmsnorm scales).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import bench as jax_bench
from tpu_dra.workloads import model as jm
from tpu_dra_torch import bench as tbench
from tpu_dra_torch import entry as tentry
from tpu_dra_torch.workloads import model as tm

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(vocab=128, d_model=64, n_heads=2, n_layers=2, d_ff=128,
             max_seq=256)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tokens(seed=1, batch=2, seq=256, vocab=128):
    return np.random.RandomState(seed).randint(0, vocab, (batch, seq))


def _jax_tree_np(params):
    return jax.tree.map(np.asarray, params)


def _named_jax_leaves(tree):
    out = {"embed": tree["embed"], "unembed": tree["unembed"]}
    for i, bp in enumerate(tree["blocks"]):
        for name, leaf in bp.items():
            out[f"blocks.{i}.{name}"] = leaf
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def parity(request):
    """Logits, loss and grads of both models at SMALL, one dtype."""
    jdtype, tdtype = DTYPES[request.param]
    cfg_j = jm.ModelConfig(**SMALL, dtype=jdtype, attn_impl="flash_interpret")
    params_j = jm.init_params(jax.random.PRNGKey(0), cfg_j)
    tokens = _tokens()
    model_j = jm.TransformerLM(cfg_j)
    logits_j = model_j.forward(params_j, jnp.asarray(tokens[:, :-1]))
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jm.loss_fn(model_j, p, jnp.asarray(tokens)))(params_j)

    cfg_t = tm.ModelConfig(**SMALL, dtype=tdtype, attn_impl="flash")
    model_t = tm.TransformerLM(
        cfg_t, tm.params_from_jax(_jax_tree_np(params_j), cfg_t, "cpu"))
    tokens_t = torch.from_numpy(tokens)
    logits_t = model_t(tokens_t[:, :-1]).detach()
    loss_t = tm.loss_fn(model_t, tokens_t)
    names = [n for n, _ in model_t.named_parameters()]
    grads_t = torch.autograd.grad(loss_t, list(model_t.parameters()))
    return {
        "dtype": request.param,
        "logits": (logits_t.numpy(), np.asarray(logits_j)),
        "loss": (float(loss_t.detach()), float(loss_j)),
        "grads": {n: (g.numpy(), np.asarray(_named_jax_leaves(grads_j)[n]))
                  for n, g in zip(names, grads_t)},
    }


class TestModelParity:
    def test_logits(self, parity):
        got, want = parity["logits"]
        assert got.shape == (2, 255, SMALL["vocab"])
        assert got.dtype == np.float32
        if parity["dtype"] == "float32":
            assert _rel(got, want) <= 1e-4
        else:
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 1e-2, f"logits rel norm {rel}"

    def test_loss(self, parity):
        got, want = parity["loss"]
        tol = 1e-4 if parity["dtype"] == "float32" else 1e-2
        assert abs(got - want) <= tol * abs(want)

    def test_every_gradient_leaf(self, parity):
        grads = parity["grads"]
        assert len(grads) == 2 + 6 * SMALL["n_layers"]
        tol = 1e-4 if parity["dtype"] == "float32" else 5e-2
        errs = {n: _rel(g, w) for n, (g, w) in grads.items()}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= tol, f"grad {worst} rel err {errs[worst]}"


class TestTrainStep:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_one_sgd_step_matches_reference(self, dtype):
        """New params of one SGD step against the reference's jitted
        make_train_step on a 1x1 CPU mesh (both "auto" on the CPU: the
        plain attention path). lr=0.1 makes the update large against
        the fp32 rounding of the params themselves."""
        jdtype, tdtype = DTYPES[dtype]
        lr = 0.1
        cfg_j = jm.ModelConfig(**SMALL, dtype=jdtype)
        params_j = jm.init_params(jax.random.PRNGKey(3), cfg_j)
        old = _named_jax_leaves(_jax_tree_np(params_j))
        tokens = _tokens(seed=4)
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
        step_j = jm.make_train_step(jm.TransformerLM(cfg_j), mesh, lr=lr)
        new_j, loss_j = step_j(params_j, jnp.asarray(tokens))
        new_j = _named_jax_leaves(_jax_tree_np(new_j))

        cfg_t = tm.ModelConfig(**SMALL, dtype=tdtype)
        model_t = tm.TransformerLM(
            cfg_t, tm.params_from_jax(_jax_tree_np(params_j), cfg_t, "cpu"))
        loss_t = tm.make_train_step(model_t, lr=lr)(torch.from_numpy(tokens))
        new_t = {n: p.detach().numpy()
                 for n, p in model_t.named_parameters()}

        loss_tol = 1e-5 if dtype == "float32" else 1e-2
        assert abs(float(loss_t) - float(loss_j)) <= loss_tol * float(loss_j)
        upd_tol = 1e-3 if dtype == "float32" else 5e-2
        for name, want in new_j.items():
            d_want = want - old[name]
            d_got = new_t[name] - old[name]
            scale = np.abs(d_want).max()
            assert scale > 0, f"{name} not updated by the reference"
            err = np.abs(d_got - d_want).max()
            # fp32 cancellation in new - old: a few ulps of |param|.
            assert err <= upd_tol * scale + 1e-6 * np.abs(old[name]).max(), \
                f"{name}: update err {err} vs scale {scale}"


class TestParamsAndConfig:
    def test_params_from_jax_is_a_copy(self):
        cfg = tm.ModelConfig(**SMALL, dtype=torch.float32)
        tree = _jax_tree_np(jm.init_params(jax.random.PRNGKey(5),
                                           jm.ModelConfig(**SMALL)))
        model = tm.TransformerLM(cfg, tm.params_from_jax(tree, cfg, "cpu"))
        for name, leaf in _named_jax_leaves(tree).items():
            got = dict(model.named_parameters())[name]
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.detach().numpy(), leaf)

    def test_params_from_jax_refuses_depth_mismatch(self):
        tree = _jax_tree_np(jm.init_params(jax.random.PRNGKey(5),
                                           jm.ModelConfig(**SMALL)))
        cfg = tm.ModelConfig(**{**SMALL, "n_layers": 3})
        with pytest.raises(ValueError, match="blocks"):
            tm.params_from_jax(tree, cfg, "cpu")

    def test_init_params_shapes_match_reference(self):
        cfg = tm.ModelConfig(**SMALL)
        got = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        want = jm.init_params(jax.random.PRNGKey(0), jm.ModelConfig(**SMALL))
        got_n = _named_jax_leaves(got)
        for name, leaf in _named_jax_leaves(want).items():
            assert tuple(got_n[name].shape) == leaf.shape, name
            assert got_n[name].dtype == torch.float32

    @pytest.mark.parametrize("remat", ["dots", "full"])
    def test_remat_not_ported_yet(self, remat):
        """The policies the port once refused now build and recompute the
        same fp32 function: loss and every gradient leaf as "none"'s
        within 1e-6 relative (recomputation repeats the same ops)."""
        runs = {}
        for policy in ("none", remat):
            cfg = tm.ModelConfig(**SMALL, remat=policy, dtype=torch.float32)
            params = tm.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
            model = tm.TransformerLM(cfg, params)
            loss = tm.loss_fn(model, torch.from_numpy(_tokens()))
            runs[policy] = (float(loss.detach()), torch.autograd.grad(
                loss, list(model.parameters())))
        assert abs(runs[remat][0] - runs["none"][0]) <= 1e-6 * runs["none"][0]
        for got, want in zip(runs[remat][1], runs["none"][1]):
            assert _rel(got.numpy(), want.numpy()) <= 1e-6

    def test_unknown_remat_refused(self):
        cfg = tm.ModelConfig(**SMALL, remat="everything")
        params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(ValueError, match="remat"):
            tm.TransformerLM(cfg, params)


class TestEntryAndBench:
    def test_entry_matches_reference_tokens(self):
        import __graft_entry__
        _, (_, want_tokens) = __graft_entry__.entry()
        model, (tokens,) = tentry.entry(device="cpu")
        np.testing.assert_array_equal(tokens.numpy(),
                                      np.asarray(want_tokens))
        logits = model(tokens)
        assert logits.shape == (2, model.cfg.max_seq, model.cfg.vocab)
        assert bool(torch.isfinite(logits).all())

    def test_flops_per_token_matches_reference(self):
        cfg_t = tm.ModelConfig(**SMALL)
        n_t = sum(p.numel() for p in tm.TransformerLM(
            cfg_t, tm.init_params(cfg_t, torch.Generator().manual_seed(0),
                                  "cpu")).parameters())
        tree = jm.init_params(jax.random.PRNGKey(0), jm.ModelConfig(**SMALL))
        n_j = sum(x.size for x in jax.tree.leaves(tree))
        assert n_t == n_j
        assert (tbench._flops_per_token(cfg_t, n_t)
                == jax_bench._flops_per_token(jm.ModelConfig(**SMALL), n_j))

    def test_flagship_step_flops(self):
        """~23.9 TFLOP of model FLOPs per flagship step (8 x 1023 tokens):
        ~24 ms at the H100 SXM's 989 TFLOP/s dense bf16 peak."""
        cfg = tbench.FLAGSHIP
        d, f, v, n = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
        n_params = 2 * v * d + n * (2 * d + 3 * d * d + d * d + 2 * d * f)
        per_token, _ = tbench._flops_per_token(cfg, n_params)
        step = per_token * tbench.FLAGSHIP_BATCH * (cfg.max_seq - 1)
        assert abs(step - 23.9e12) <= 0.01 * 23.9e12

    def test_train_step_rate_runs_on_cpu_at_tiny_size(self):
        cfg = tm.ModelConfig(vocab=64, d_model=32, n_heads=2, n_layers=1,
                             d_ff=64, max_seq=16, dtype=torch.float32)
        step_s, loss, model, calls = tbench._train_step_rate(cfg, 2, 2,
                                                             "cpu")
        assert step_s > 0 and np.isfinite(loss) and calls == 5


class TestNoCpuFallback:
    """Entry points default to the card and raise where there is none.
    torch.cuda.is_available is patched to False, so these hold on a host
    with a card too."""

    @pytest.fixture(autouse=True)
    def no_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_entry_raises_without_card(self):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tentry.entry()

    def test_init_params_raises_without_card(self):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.init_params(tm.ModelConfig(**SMALL),
                           torch.Generator().manual_seed(0))

    @pytest.mark.parametrize("device", ["cuda", "cpu"])
    def test_bench_mfu_measures_only_a_card(self, device):
        with pytest.raises(RuntimeError):
            tbench.bench_mfu(steps=1, device=device)


class TestImportIsolation:
    def test_port_imports_neither_jax_nor_reference(self):
        """Every module of the package, as pkgutil walks it, and
        chip_smoke: none may bring jax, jaxlib or tpu_dra into
        sys.modules."""
        code = (
            "import importlib, pkgutil, sys\n"
            "import tpu_dra_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    tpu_dra_torch.__path__, 'tpu_dra_torch.')]\n"
            "for m in names + ['chip_smoke']: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tpu_dra'))\n"
            "print(len(names), bad)\n"
            "sys.exit(1 if bad or len(names) < 77 else 0)\n")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr

    def test_no_import_statement_names_jax_or_reference(self):
        files = sorted((ROOT / "tpu_dra_torch").rglob("*.py"))
        files.append(ROOT / "chip_smoke.py")
        assert len(files) >= 8
        hits = []
        for path in files:
            for node in ast.walk(ast.parse(path.read_text())):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    continue
                hits += [f"{path.relative_to(ROOT)}: {n}" for n in names
                         if n.split(".")[0] in ("jax", "jaxlib", "tpu_dra")]
        assert not hits, hits

    def test_grpc_only_inside_functions_and_no_protobuf(self):
        """The port's modules import neither grpc nor google.protobuf at
        module level (the card may lack both; the framed transport needs
        neither), and nothing imports google.protobuf at all."""
        module_level, protobuf = [], []
        for path in sorted((ROOT / "tpu_dra_torch").rglob("*.py")):
            tree = ast.parse(path.read_text())
            top = set(map(id, tree.body))
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    continue
                where = f"{path.relative_to(ROOT)}:{node.lineno}"
                if any(n.startswith("google") for n in names):
                    protobuf.append(where)
                if id(node) in top and any(n.split(".")[0] == "grpc"
                                           for n in names):
                    module_level.append(where)
        assert not module_level, module_level
        assert not protobuf, protobuf
