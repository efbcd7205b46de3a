"""The recurrent leaves that ``init_params`` sets to zero, drawn for tests.

Imports no JAX, so the card's tests can use it too; a JAX array leaf is
rebuilt with ``jax.numpy`` only when one is met.
"""

import numpy as np
import torch

# The recurrent leaves the reference initialises at zero (``init="zeros"``),
# by the sublayer that holds them.  At zero they hide most of what the
# recurrences carry: the token shift ignores the previous row (``mu``), the
# first-token bonus vanishes (``bonus``), and the conv taps (``conv_w``,
# ``conv_b``) keep the RG-LRU's input, and so its state, at zero.  The
# recurrent tests draw them from a numpy seed, on both sides alike.
RECURRENT_LEAVES = {"tm": ("mu", "w0", "bonus", "ln_x"), "cm": ("mu",),
                    "rglru": ("conv_w", "conv_b", "b_input_gate",
                              "b_rec_gate", "lambda_p")}


def _draw_leaf(rng, name, shape):
    if name == "mu":                 # a token-shift mix, in [0, 1]
        return rng.uniform(0.0, 1.0, shape)
    if name == "lambda_p":           # a = exp(-8 r softplus): ~0.3-0.8
        return rng.normal(-2.0, 1.0, shape)
    return 0.5 * rng.standard_normal(shape)


def draw_recurrent_leaves(tree, seed: int = 0):
    """A copy of a params tree (the reference's stacked one or the port's
    per-layer one) with every ``RECURRENT_LEAVES`` leaf drawn from
    ``seed``; the other leaves are shared.  Reference and port trees drawn
    with one seed get the same values only through ``from_reference``:
    draw the reference's and carry it across."""
    rng = np.random.default_rng(seed)

    def leaf(old, name):
        val = _draw_leaf(rng, name, tuple(old.shape)).astype(np.float32)
        if torch.is_tensor(old):
            return torch.from_numpy(val).to(old.dtype).to(old.device)
        import jax.numpy as jnp
        return jnp.asarray(val, old.dtype)

    def walk(node, key=None):
        if isinstance(node, dict):
            names = RECURRENT_LEAVES.get(key, ())
            return {k: leaf(v, k) if k in names else walk(v, k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, key) for v in node)
        return node
    return walk(tree)
