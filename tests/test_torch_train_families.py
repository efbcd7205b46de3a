"""The port's loss and gradients against the reference's ``loss_fn`` for
seven of the ten reduced configs (smollm, phi3.5 and gemma, and the rest of
the training path, in test_torch_train.py): the MLA models (deepseek-v2,
minicpm3), minitron (GQA), the recurrent families (rwkv6,
recurrentgemma), and the frontend families (whisper with its ``frames``,
qwen2-vl with its ``embeds`` and ``mask``).  float32, the
zero-initialised leaves drawn, each config held to its ``GRAD_BOUND``.

Where a bound exceeds 1e-4 of a leaf's largest gradient, the float32
gradient itself is that uncertain: the test below runs the port's forward
and backward again in float64 and shows the reference's float32 gradients
stray from it by the same order as the port's (the port's within three
times the reference's, plus 1e-4).  A wrong gradient would stray by orders
of magnitude more.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_train_helpers import (GRAD_BOUND, LOSS_RTOL,  # noqa: E402
                                  LOSS_RTOL_WHISPER,
                                  assert_grads_close, batch_np, leaf_errors,
                                  port_loss_and_grads, ref_loss_and_grads,
                                  train_params)
from repro_torch.training.tree import tree_map  # noqa: E402

ARCHS = ("deepseek-v2-236b", "minicpm3-4b", "minitron-8b", "rwkv6-1.6b",
         "recurrentgemma-9b", "whisper-tiny", "qwen2-vl-7b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    rcfg, rp, tcfg, tp = train_params(arch)
    b = batch_np(tcfg)[0]
    if arch == "qwen2-vl-7b":
        assert {"embeds", "mask"} <= set(b)
    if arch == "whisper-tiny":
        assert "frames" in b
    rl, rparts, rg = ref_loss_and_grads(rcfg, rp, tcfg, b, remat=False)
    tl, tparts, tg = port_loss_and_grads(tp, tcfg, b, remat=False)
    rtol = LOSS_RTOL_WHISPER if arch == "whisper-tiny" else LOSS_RTOL
    np.testing.assert_allclose(tl, rl, rtol=rtol)
    np.testing.assert_allclose(tparts["ce"], rparts["ce"], rtol=rtol)
    assert_grads_close(tg, rg, GRAD_BOUND[arch], arch)


@contextlib.contextmanager
def _float_is_f64():
    """``Tensor.float()`` (the port's float32 upcasts) gives float64, so a
    float64 tree runs every step of the forward and backward in float64."""
    orig = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = orig


@pytest.mark.parametrize("arch", ["gemma-2b", "whisper-tiny"])
def test_f32_gradients_as_close_to_f64_as_the_reference(arch):
    """The two configs with the largest bounds: the reference's float32
    gradients stray from the float64 ones by the same order as the port's
    do, so the bound measures float32, not the port."""
    rcfg, rp, tcfg, tp = train_params(arch)
    b = batch_np(tcfg)[0]
    _, _, rg = ref_loss_and_grads(rcfg, rp, tcfg, b, remat=False)
    _, _, tg = port_loss_and_grads(tp, tcfg, b, remat=False)
    b64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v
           for k, v in b.items()}
    with _float_is_f64():
        _, _, g64 = port_loss_and_grads(tree_map(lambda t: t.double(), tp),
                                        tcfg, b64, remat=False)
    assert all(t.dtype == torch.float64 for t in g64["groups"][0][0]
               ["attn"].values())
    port_err = max(leaf_errors(tg, g64).values())
    ref_err = max(leaf_errors(rg, g64).values())
    assert ref_err > 1e-4 and port_err <= 3 * ref_err + 1e-4, \
        (port_err, ref_err)
