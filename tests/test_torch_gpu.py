"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card.  Skips without one; imports nothing of JAX, so it also runs where
only the port is installed:

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: float32 to 1e-4; bf16 to one bf16 rounding step of the f32
result (atol 1e-2, rtol 1.6e-2); top-k ids exactly; every exact-zero
contract exactly.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build and run only there)")
    return torch.device("cuda")


def _tol(dt):
    return (1e-4, 1e-4) if dt == torch.float32 else (1e-2, 1.6e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_chunk_paged_on_card(dev, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cpu").manual_seed(0)
    b, sq, nq, nkv, hd, page, nb, n_pages = 4, 8, 12, 4, 64, 4, 5, 16
    q = torch.randn(b, sq, nq, hd, generator=g).to(dev, dt)
    kp = torch.randn(n_pages, page, nkv, hd, generator=g).to(dev, dt)
    vp = torch.randn(n_pages, page, nkv, hd, generator=g).to(dev, dt)
    bt = torch.full((b, nb), -1, dtype=torch.int32)
    bt[0, :4] = torch.tensor([3, 9, 1, 12])
    bt[1, :4] = torch.tensor([0, 5, 7, 2])
    i32 = dict(dtype=torch.int32, device=dev)
    q_off = torch.tensor([6, 13, 0, 0], **i32)
    q_len = torch.tensor([8, 1, 0, 3], **i32)
    kv_len = torch.tensor([14, 14, 0, 0], **i32)
    args = (q, kp, vp, bt.to(dev), q_off, q_len, kv_len)
    ops.reset_counters()
    got = ops.flash_chunk_paged(*args)
    want = ref.flash_chunk_paged_ref(*args)
    atol, rtol = _tol(dt)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert (got[0, 8:] == 0).all() and (got[1, 1:] == 0).all()
    assert (got[2] == 0).all() and (got[3] == 0).all()
    assert ops.counters["flash_chunk_paged"] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_gate_on_card(dev, dtype):
    dt = getattr(torch, dtype)
    logits = torch.randn(300, 16, device=dev).to(dt)
    logits[0] = 0.5
    logits[1, 9] = logits[1, 4] = 3.0
    w, i = ops.topk_gate(logits, 2)
    w_r, i_r = ref.topk_gate_ref(logits, 2)
    assert torch.equal(i, i_r)
    assert i[0].tolist() == [0, 1] and i[1].tolist() == [4, 9]
    torch.testing.assert_close(w, w_r, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_gemm_on_card(dev, dtype):
    dt = getattr(torch, dtype)
    x = torch.randn(200, 256, device=dev).to(dt)
    w = (torch.randn(4, 256, 96, device=dev) / 16).to(dt)
    off = torch.tensor([0, 37, 37, 90, 150], dtype=torch.int32, device=dev)
    out = ops.grouped_gemm(x, w, off)
    atol, rtol = _tol(dt)
    torch.testing.assert_close(out.float(),
                               ref.grouped_gemm_ref(x, w, off).float(),
                               atol=atol, rtol=rtol)
    assert (out[150:] == 0).all()


def test_wrapper_refuses_mixed_devices(dev):
    x = torch.randn(8, 16, device=dev)
    w = torch.randn(2, 16, 4)
    with pytest.raises(ValueError, match="one device"):
        ops.grouped_gemm(x, w, torch.tensor([0, 3, 8], dtype=torch.int32))
