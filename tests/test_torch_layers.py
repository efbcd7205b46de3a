"""The port's layer functions against the reference's, same inputs.

Tolerance 1e-5 (float32; the two frameworks sum in different orders).
The paged unified attention step is checked for a prefill, a decode and a
mixed ragged step, with kernels off (the reference's jnp bodies vs the
port's plain bodies) and with the flash_chunk policy on (the reference's
interpret-mode Pallas kernel vs the port's wrapper, which runs the plain
version for CPU tensors).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as RC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from _torch_helpers import jj, paged_tables, tt  # noqa: E402
from repro.core.partitioner import make_plan as r_make_plan  # noqa: E402
from repro.kernels.policy import KernelPolicy as RPolicy  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.core.partitioner import make_plan as t_make_plan  # noqa
from repro_torch.kernels.policy import KernelPolicy as TPolicy  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(kw or TOL))


def test_norm_activation_rope_positions():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    _close(TL.rms_norm(tt(x), tt(w), 1e-6), RL.rms_norm(jj(x), jj(w), 1e-6))
    for kind in ("swiglu", "geglu", "gelu"):
        _close(TL.activate(tt(x), tt(x[::-1].copy()), kind),
               RL.activate(jj(x), jj(x[::-1].copy()), kind))
    _close(TL.rope_freqs(16, 10000.0), RL.rope_freqs(16, 10000.0))
    idx = np.array([3, 11], np.int32)
    pos_t = TL.positions_from(tt(idx), 5)
    np.testing.assert_array_equal(pos_t.numpy(),
                                  np.asarray(RL.positions_from(jj(idx), 5)))
    _close(TL.apply_rope(tt(x), pos_t, 10000.0),
           RL.apply_rope(jj(x), RL.positions_from(jj(idx), 5), 10000.0))


def test_paged_write_and_gather_match_reference():
    rng = np.random.default_rng(1)
    b, s, page, nb = 3, 6, 4, 4
    bt, n_pages = paged_tables(b, nb, [3, 2, 0])
    pool = rng.standard_normal((n_pages, page, 2, 8)).astype(np.float32)
    new = rng.standard_normal((b, s, 2, 8)).astype(np.float32)
    idx = np.array([5, 2, 0], np.int32)
    qlen = np.array([6, 3, 0], np.int32)
    got = TL.write_cache_paged(tt(pool), tt(new), tt(idx), tt(bt), tt(qlen))
    want = RL.write_cache_paged(jj(pool), jj(new), jj(idx), jj(bt),
                                valid_len=jj(qlen))
    _close(got, want, rtol=0, atol=0)
    _close(TL.gather_pages(got, tt(bt)), RL.gather_pages(want, jj(bt)),
           rtol=0, atol=0)


def test_chunked_and_decode_attention_match_reference():
    rng = np.random.default_rng(2)
    b, sq, skv, nq, nkv, hd = 3, 6, 16, 6, 2, 8
    q = rng.standard_normal((b, sq, nq, hd)).astype(np.float32)
    k = rng.standard_normal((b, skv, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, skv, nkv, hd)).astype(np.float32)
    off = np.array([0, 4, 9], np.int32)
    kvl = off + np.array([6, 2, 1], np.int32)
    _close(TL.chunked_attention(tt(q), tt(k), tt(v), q_offset=tt(off),
                                kv_len=tt(kvl)),
           RL.chunked_attention(jj(q), jj(k), jj(v), q_offset=jj(off),
                                kv_len=jj(kvl), causal=True))
    pos = np.array([[3], [7], [15]], np.int32)
    _close(TL.decode_attention(tt(q[:, :1]), tt(k), tt(v),
                               kv_len=tt(pos[:, 0] + 1),
                               q_positions=tt(pos)),
           RL.decode_attention(jj(q[:, :1]), jj(k), jj(v),
                               kv_len=jj(pos[:, 0] + 1),
                               q_positions=jj(pos)))


@pytest.mark.parametrize("kernels", ["off", "flash_chunk"])
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b", "smollm-360m"])
def test_gqa_attention_paged_unified_steps(arch, kernels):
    """Prefill, then decode, then a mixed ragged step, on one paged cache."""
    rcfg, tcfg = RC.get_reduced(arch), TC.get_reduced(arch)
    rng = np.random.default_rng(3)
    h, nq, nkv, hd = rcfg.d_model, rcfg.n_heads, rcfg.n_kv_heads, \
        rcfg.head_dim
    p = {"wq": rng.standard_normal((h, nq, hd)) * h ** -0.5,
         "wk": rng.standard_normal((h, nkv, hd)) * h ** -0.5,
         "wv": rng.standard_normal((h, nkv, hd)) * h ** -0.5,
         "wo": rng.standard_normal((nq, hd, h)) * (nq * hd) ** -0.5,
         "norm": rng.standard_normal(h) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    b, s, page, nb = 3, 8, 4, 6
    bt, n_pages = paged_tables(b, nb, [6, 5, 6], seed=3)
    kp = np.zeros((n_pages, page, nkv, hd), np.float32)
    r_kv = (jj(kp), jj(kp))
    t_kv = (tt(kp), tt(kp))
    r_plan = r_make_plan("mixserve", None, kernels=RPolicy(
        flash_chunk=kernels != "off"))
    t_plan = t_make_plan("mixserve", None, kernels=TPolicy(
        flash_chunk=kernels != "off"))
    length = np.zeros(b, np.int32)
    for q_lens in ([8, 5, 0], [1, 1, 0], [1, 7, 3]):
        q_lens = np.array(q_lens, np.int32)
        sq = s if q_lens.max() > 1 else 1
        x = rng.standard_normal((b, sq, h)).astype(np.float32)
        r_out, r_kv = RL.gqa_attention(
            {k: jj(v) for k, v in p.items()}, jj(x), rcfg, r_plan,
            cache=RL.KVView(r_kv[0], r_kv[1], jj(length), jj(bt)),
            q_lens=jj(q_lens))
        t_out, t_kv = TL.gqa_attention(
            {k: tt(v) for k, v in p.items()}, tt(x), tcfg, t_plan,
            cache=TL.KVView(t_kv[0], t_kv[1], tt(length), tt(bt)),
            q_lens=tt(q_lens))
        for i in range(b):       # rows past q_len are inert
            _close(t_out[i, :q_lens[i]], r_out[i, :q_lens[i]])
        _close(t_kv[0], r_kv[0])
        _close(t_kv[1], r_kv[1])
        length = length + q_lens


def test_mlp_matches_reference():
    rcfg, tcfg = RC.get_reduced("smollm-360m"), TC.get_reduced("smollm-360m")
    rng = np.random.default_rng(4)
    h, f = rcfg.d_model, rcfg.d_ff
    p = {"w_in": rng.standard_normal((h, f)) * h ** -0.5,
         "w_gate": rng.standard_normal((h, f)) * h ** -0.5,
         "w_out": rng.standard_normal((f, h)) * f ** -0.5,
         "norm": rng.standard_normal(h) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 3, h)).astype(np.float32)
    _close(TL.mlp({k: tt(v) for k, v in p.items()}, tt(x), tcfg),
           RL.mlp({k: jj(v) for k, v in p.items()}, jj(x), rcfg))
