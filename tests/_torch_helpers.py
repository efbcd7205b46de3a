"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

Both packages get the same inputs: weights are the reference's params
carried across through numpy (``repro_torch.bridge.from_reference``), and
every other input is drawn with numpy from a fixed seed.  The port runs on
the CPU (``device="cpu"``), JAX on the CPU too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as RC
import repro_torch.configs as TC
from repro.models.model import init_params as ref_init_params
from _recurrent_leaves import draw_recurrent_leaves
from repro_torch.bridge import from_reference

# The shapes here are tiny; one intra-op thread per test process keeps the
# port's tests from crowding the timing-sensitive tests that xdist runs
# beside them on the same cores.
torch.set_num_threads(1)


def tt(a, dtype=None):
    """numpy -> torch (CPU), keeping integer dtypes unless told."""
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def jj(a):
    return jnp.asarray(np.asarray(a))


def both_params(arch: str, seed: int = 0):
    """(ref cfg, ref params, port cfg, port params) for a reduced arch."""
    rcfg, tcfg = RC.get_reduced(arch), TC.get_reduced(arch)
    rp = ref_init_params(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    tp = from_reference(jax.tree.map(np.asarray, rp), tcfg)
    return rcfg, rp, tcfg, tp


def recurrent_params(arch: str, seed: int = 0, **cfg_kw):
    """(ref cfg, ref params, port cfg, port params) for a reduced recurrent
    arch with ``cfg_kw`` replaced, the zero-initialised recurrent leaves
    drawn from ``seed`` (``draw_recurrent_leaves``)."""
    rcfg = dataclasses.replace(RC.get_reduced(arch), **cfg_kw)
    tcfg = dataclasses.replace(TC.get_reduced(arch), **cfg_kw)
    rp = draw_recurrent_leaves(
        ref_init_params(jax.random.PRNGKey(seed), rcfg, jnp.float32), seed)
    return rcfg, rp, tcfg, from_reference(jax.tree.map(np.asarray, rp),
                                          tcfg)


def paged_tables(b: int, nb: int, used_blocks, seed: int = 0):
    """(b, nb) int32 block tables: slot i owns ``used_blocks[i]`` distinct
    random pages, the rest of its row is -1.  Returns (tables, n_pages)."""
    rng = np.random.default_rng(seed)
    n_pages = int(sum(used_blocks)) + 2
    perm = rng.permutation(n_pages)
    bt = np.full((b, nb), -1, np.int32)
    k = 0
    for i, n in enumerate(used_blocks):
        bt[i, :n] = perm[k:k + n]
        k += n
    return bt, n_pages
