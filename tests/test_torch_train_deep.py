"""Why the card's smollm-360m run trains with the gradient clip off.

At 32 layers the random init's gradient norm runs to ~1e5, so the default
clip (1.0) shrinks every gradient entry that much, most of them under
Adam's eps (1e-8), and the first steps barely move the loss; with the clip
off the same schedule learns.  The reference does the same as the port:
smollm-360m's reduced widths at 32 layers, 20 steps of batch 4 x 32 under
test_training.py's schedule (lr 2e-3, warm-up 3, 30 steps), both packages
from the same weights.  ``chip_smoke.py`` phase 6 (b) shows it again at
full width.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from _torch_train_helpers import batch_np, to_port, to_ref  # noqa: E402
from repro.models.model import init_params as ref_init  # noqa: E402
from repro.training import optimizer as ROPT  # noqa: E402
from repro.training import train_step as RTS  # noqa: E402
from repro_torch.bridge import from_reference  # noqa: E402
from repro_torch.training import optimizer as TOPT  # noqa: E402
from repro_torch.training import train_step as TTS  # noqa: E402

LAYERS, STEPS = 32, 20


def _drop(losses):
    return float(np.mean(losses[:5]) - np.mean(losses[-5:]))


@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "no_clip"])
def test_deep_model_learns_only_without_the_clip(clip):
    rcfg = dataclasses.replace(RC.get_reduced("smollm-360m"),
                               n_layers=LAYERS)
    tcfg = dataclasses.replace(TC.get_reduced("smollm-360m"),
                               n_layers=LAYERS)
    rp = jax.jit(ref_init, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), rcfg, jnp.float32)
    tp = from_reference(jax.tree.map(np.asarray, rp), tcfg)
    kw = dict(lr=2e-3, warmup_steps=3, total_steps=30, grad_clip=clip)
    r_step = jax.jit(RTS.make_train_step(rcfg, opt_cfg=ROPT.AdamWConfig(
        **kw), remat=False))
    t_step = TTS.make_train_step(tcfg, opt_cfg=TOPT.AdamWConfig(**kw),
                                 remat=False)
    r_opt, t_opt = ROPT.init_opt_state(rp), TOPT.init_opt_state(tp)
    r_loss, t_loss, gnorm = [], [], []
    for b in batch_np(tcfg, batch=4, seq=32, n=STEPS):
        rp, r_opt, rm = r_step(rp, r_opt, to_ref(b))
        tp, t_opt, tm = t_step(tp, t_opt, to_port(b))
        r_loss.append(float(rm["loss"]))
        t_loss.append(float(tm["loss"]))
        gnorm.append(float(tm["grad_norm"]))
    assert np.isfinite(r_loss + t_loss).all()
    assert min(gnorm) > 1e3
    if clip:
        assert _drop(r_loss) < 0.1 and _drop(t_loss) < 0.1, \
            (_drop(r_loss), _drop(t_loss))
    else:
        assert _drop(r_loss) > 0.15 and _drop(t_loss) > 0.15, \
            (_drop(r_loss), _drop(t_loss))
