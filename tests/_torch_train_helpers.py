"""Shared pieces of the training parity tests (tests/test_torch_train*.py).

Both packages start from the reference's weights with every leaf
``init_params`` sets to zero drawn from a numpy seed (the norms' weights,
the recurrent leaves of ``_recurrent_leaves``), so a swapped or skipped
norm or gate cannot hide behind ``1 + 0``; the port gets them through
``bridge.from_reference``.  Batches come from the port's copy of the
synthetic pipeline.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as RC
import repro_torch.configs as TC
from _recurrent_leaves import _draw_leaf
from repro.models.model import init_params as ref_init_params
from repro.training.train_step import loss_fn as ref_loss_fn
from repro_torch.bridge import from_reference
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.training.train_step import value_and_grad
from repro_torch.training.tree import flatten_with_paths

torch.set_num_threads(1)

# Each config's bound on a gradient leaf: |port - reference| <= bound *
# max|reference leaf|.  The loss agrees to 1e-5 relative on every config.
# Where the bound exceeds 1e-4 the gradient is ill-conditioned in float32:
# the leaves nearest the input are sums of terms far larger than their
# result (peaked attention under the random init), and the reference's own
# float32 gradient strays from the same computation in float64 by the same
# order as the port's (test_torch_train_families.py::test_f32_gradients_
# as_close_to_f64_as_the_reference: gemma 4.1e-4 against the port's
# 1.2e-3, whisper 6.9e-3 against 3.0e-3).  Each bound is about three times
# the largest difference seen over two draws of the weights (gemma 7.4e-4
# and 1.5e-3, whisper 4.0e-3 and 3.9e-3), at batch 2 x 32 tokens.
GRAD_BOUND = {
    "smollm-360m": 6e-4,
    "phi3.5-moe-42b": 1.5e-3,
    "gemma-2b": 5e-3,
    "deepseek-v2-236b": 1e-4,
    "minicpm3-4b": 1e-4,
    "minitron-8b": 2e-3,
    "rwkv6-1.6b": 1e-4,
    "recurrentgemma-9b": 1e-3,
    "whisper-tiny": 1.5e-2,
    "qwen2-vl-7b": 1e-3,
}
# the loss, relative; whisper's float32 outputs are chaotic under a change
# of summation order (ROADMAP queue C): 1e-4
LOSS_RTOL = 1e-5
LOSS_RTOL_WHISPER = 1e-4


def draw_zero_leaves(tree, seed: int = 1):
    """The reference's params tree with every all-zero leaf drawn from
    ``seed`` (``_recurrent_leaves._draw_leaf``: token-shift mixes in
    [0, 1], the RG-LRU's ``lambda_p`` around -2, the rest 0.5 N(0, 1))."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for path, leaf in flat:
        a = np.asarray(leaf)
        if not a.any():
            name = str(getattr(path[-1], "key", ""))
            a = _draw_leaf(rng, name, a.shape).astype(np.float32)
        out.append(jnp.asarray(a, leaf.dtype))
    return jax.tree_util.tree_unflatten(treedef, out)


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str, seed: int):
    """The reference's float32 weights of a reduced arch, the zero leaves
    drawn (initialised under jit: a few times faster than eagerly)."""
    rcfg = RC.get_reduced(arch)
    init = jax.jit(ref_init_params, static_argnums=(1, 2))
    return draw_zero_leaves(init(jax.random.PRNGKey(seed), rcfg,
                                 jnp.float32), seed + 1)


def train_params(arch: str, seed: int = 0):
    """(ref cfg, ref params, port cfg, port params) for a reduced arch in
    float32, the zero leaves drawn; the port's tree is fresh on every
    call (its steps update it in place)."""
    rcfg, tcfg = RC.get_reduced(arch), TC.get_reduced(arch)
    rp = _ref_params(arch, seed)
    return rcfg, rp, tcfg, from_reference(jax.tree.map(np.asarray, rp),
                                          tcfg)


def batch_np(cfg, batch: int = 2, seq: int = 32, seed: int = 0, n: int = 1):
    """``n`` numpy batches of the synthetic pipeline."""
    return list(SyntheticLM(cfg, DataConfig(batch=batch, seq_len=seq,
                                            seed=seed)).batches(n))


def to_ref(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_port(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def ref_grads(rcfg, rp, b, **kw):
    """((loss, parts), grads) of the reference's ``loss_fn`` by a jitted
    ``jax.value_and_grad`` (its tree, stacked)."""
    return jax.jit(jax.value_and_grad(
        lambda p, bb: ref_loss_fn(p, bb, rcfg, **kw), has_aux=True))(
            rp, to_ref(b))


def ref_loss_and_grads(rcfg, rp, tcfg, b, **kw):
    """(loss, parts, grads in the port's layout) of ``ref_grads``."""
    (loss, parts), g = ref_grads(rcfg, rp, b, **kw)
    return float(loss), {k: float(v) for k, v in parts.items()}, \
        from_reference(jax.tree.map(np.asarray, g), tcfg)


def port_loss_and_grads(tp, tcfg, b, **kw):
    (loss, parts), g = value_and_grad(tp, to_port(b), tcfg, **kw)
    return float(loss), {k: float(v) for k, v in parts.items()}, g


def leaf_errors(got, want) -> dict:
    """{path: max|got - want| / max|want|} over the leaves of two trees of
    one structure."""
    out = {}
    for (p, a), (q, b) in zip(flatten_with_paths(got),
                              flatten_with_paths(want)):
        assert p == q and a.shape == b.shape, (p, q)
        scale = b.abs().max().item()
        out[p] = (a.double() - b.double()).abs().max().item() \
            / max(scale, 1e-30)
    return out


def assert_grads_close(got, want, bound: float, label: str = ""):
    errs = leaf_errors(got, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= bound, \
        f"{label}: gradient leaf {worst} off by {errs[worst]:.3e} of its " \
        f"largest magnitude (bound {bound:.1e})"
