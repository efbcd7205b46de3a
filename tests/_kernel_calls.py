"""Every kernel wrapper of ``repro_torch.kernels.ops`` called on small
inputs, for the autograd guard's tests on the CPU and on the card.  Imports
no JAX."""

import torch


def wrapper_calls(dev="cpu"):
    """{name: call(requires_grad) -> output} for every kernel wrapper of
    ``kernels.ops``, on small inputs whose float tensors require grad when
    asked."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)

    def f(*shape, rg=False):
        return torch.randn(*shape, generator=g).to(dev).requires_grad_(rg)

    def i32(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)
    b, sq, nq, nkv, hd, s = 2, 3, 4, 2, 8, 6
    calls = {
        "flash_chunk": lambda rg: ops.flash_chunk(
            f(b, sq, nq, hd, rg=rg), f(b, s, nkv, hd), f(b, s, nkv, hd),
            i32([0, 2]), i32([3, 1]), i32([3, 3])),
        "flash_decode": lambda rg: ops.flash_decode(
            f(b, nq, hd, rg=rg), f(b, s, nkv, hd), f(b, s, nkv, hd),
            i32([4, 6])),
        "flash_chunk_paged": lambda rg: ops.flash_chunk_paged(
            f(b, sq, nq, hd), f(4, 2, nkv, hd, rg=rg), f(4, 2, nkv, hd),
            i32([[0, 1], [2, 3]]), i32([0, 1]), i32([3, 2]), i32([3, 3])),
        "topk_gate": lambda rg: ops.topk_gate(f(5, 8, rg=rg), 2),
        "moe_gemm": lambda rg: ops.moe_gemm(f(3, 4, 16), f(3, 16, 8, rg=rg)),
        "grouped_gemm": lambda rg: ops.grouped_gemm(
            f(6, 16, rg=rg), f(3, 16, 8), i32([0, 2, 5, 6])),
        "permute_tokens": lambda rg: ops.permute_tokens(
            f(5, 16, rg=rg), i32([4, 0, -1, 2])),
        "permute_tokens_ragged": lambda rg: ops.permute_tokens_ragged(
            f(5, 16, rg=rg), i32([4, 0, -1, 2]), i32(3)),
        "unpermute_tokens": lambda rg: ops.unpermute_tokens(
            f(6, 16), i32([[0, 5], [2, -1]]), f(2, 2, rg=rg)),
    }
    return calls
