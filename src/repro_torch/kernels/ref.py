"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its kernel in ``ops`` computes, with the same
contracts, in ordinary tensor code.  The wrappers in ``ops`` run these for
CPU tensors; the tests hold them against the reference package's oracles,
and ``chip_smoke.py`` holds each kernel against them on the card.  They
repeat the kernels' arithmetic and are no yardstick of speed.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def top_k_first(p, k: int):
    """Top-k of p (T, E) by iterative argmax: ties go to the lowest index.
    Returns (values (T, k) in p's dtype, idx (T, k) int32).  Each mask is
    a new tensor (no in-place write), so the values carry p's gradient."""
    ws, iis = [], []
    for _ in range(k):
        idx = torch.argmax(p, dim=-1)           # first maximal index
        ws.append(torch.gather(p, 1, idx[:, None])[:, 0])
        iis.append(idx)
        p = p.scatter(1, idx[:, None], -1.0)
    return torch.stack(ws, -1), torch.stack(iis, -1).to(torch.int32)


def topk_gate_ref(logits, k: int, renorm: bool = True):
    """Fused softmax + top-k router gate.

    logits (T, E) -> (weights (T, k) f32, idx (T, k) int32).  Max-subtracted
    f32 softmax, k rounds of argmax masking each pick with -1.0, then
    renormalization by ``max(sum, 1e-9)``."""
    x = logits.float()
    ex = torch.exp(x - x.amax(-1, keepdim=True))
    probs = ex / ex.sum(-1, keepdim=True)
    w, idx = top_k_first(probs, k)
    if renorm:
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    return w, idx


def moe_gemm_ref(x, w):
    """Capacity-mode batched expert GEMM.  x (E, C, H) @ w (E, H, D) ->
    (E, C, D) in x's dtype: each expert's product accumulated in float32
    and rounded once."""
    return torch.einsum("ech,ehd->ecd", x.float(), w.float()).to(x.dtype)


def grouped_gemm_ref(x, w, group_offsets):
    """Dropless segment GEMM.  x (N, H) sorted by expert, w (E, H, D),
    group_offsets (E+1,) prefix sum -> (N, D) in x's dtype: rows
    ``[offsets[e], offsets[e+1])`` use ``w[e]``, accumulated in float32.
    Rows at/after ``offsets[-1]`` are exact zeros.  An empty segment still
    runs its 0-row product, so that under autograd the output joins the
    graph of ``x`` and ``w`` whatever the routing: every rank of a mesh
    then builds the same backward, collectives included.

    On the meta device (the dry run) the offsets are values it cannot
    read: one (N, H) @ (H, D) product gives the result's shape and the
    2·N·H·D operations at which XLA prices the reference's ``ragged_dot``
    (every row of the buffer, routed or not), under autograd too."""
    if x.device.type == "meta":
        return (x.float() @ w[0].float()).to(x.dtype)
    n = x.shape[0]
    out = torch.zeros(n, w.shape[-1], dtype=x.dtype, device=x.device)
    # the plain body's segment bounds, read once (the card's kernels-on path
    # runs grouped_gemm instead)
    off = [int(o) for o in group_offsets.tolist()]  # repro-lint: disable=R2
    for e in range(w.shape[0]):
        lo, hi = off[e], min(off[e + 1], n)
        out[lo:hi] = (x[lo:hi].float() @ w[e].float()).to(x.dtype)
    return out


def flash_chunk_ref(q, k, v, q_offset, q_len, kv_len, scale=None):
    """Ragged mixed-chunk attention on a dense cache.  q (B, sq, nq, hd);
    k (B, S, nkv, hd); v (B, S, nkv, hdv); q_offset / q_len / kv_len (B,)
    -> (B, sq, nq, hdv) in q's dtype.

    Row r of slot i is a real query iff ``r < q_len[i]``, sits at position
    ``q_offset[i] + r`` and sees keys ``pos <= q_offset[i] + r`` with
    ``pos < kv_len[i]``.  Rows past ``q_len`` and rows with no visible key
    are exact zeros.  ``scale`` defaults to ``hd ** -0.5``.  Arithmetic in
    float32."""
    b, sq, nq, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(b, sq, nkv, g, hd).float() * scale
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, k.float())
    row = torch.arange(sq, device=q.device)[None, :, None]
    pos = torch.arange(skv, device=q.device)[None, None, :]
    mask = ((row < q_len.long()[:, None, None])
            & (pos < kv_len.long()[:, None, None])
            & (pos <= q_offset.long()[:, None, None] + row))   # (b, sq, S)
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1).masked_fill(~mask[:, None, None], 0.0)
    o = torch.einsum("bhgqs,bshd->bqhgd", p, v.float())
    return o.reshape(b, sq, nq, v.shape[-1]).to(q.dtype)


def flash_decode_ref(q, k, v, lengths, scale=None):
    """Single-token decode attention.  q (B, nq, hd); k (B, S, nkv, hd);
    v (B, S, nkv, hdv); lengths (B,) -> (B, nq, hdv).

    ``flash_chunk_ref`` at sq == 1 under the decode invariant: the query
    sits at ``lengths - 1`` and sees ``lengths`` keys.  A slot with
    ``lengths == 0`` gives an exact-zero row."""
    lengths = lengths.to(torch.int32)
    return flash_chunk_ref(q[:, None], k, v, (lengths - 1).clamp_min(0),
                           lengths.clamp_max(1), lengths, scale)[:, 0]


def flash_chunk_paged_ref(q, k_pages, v_pages, block_tables, q_offset,
                          q_len, kv_len, scale=None):
    """Paged ragged mixed-chunk attention.  q (B, sq, nq, hd);
    k_pages (P, page, nkv, hd); v_pages (P, page, nkv, hdv);
    block_tables (B, max_blocks) int32 (-1 = unallocated);
    q_offset / q_len / kv_len (B,) -> (B, sq, nq, hdv) in q's dtype.

    Logical key ``t`` of slot i lives at
    ``pages[block_tables[i, t // page], t % page]`` (-1 reads page 0, whose
    keys lie past ``kv_len``); the gathered slot-major view then goes
    through ``flash_chunk_ref``."""
    b, nb = block_tables.shape
    n_pages, page = k_pages.shape[0], k_pages.shape[1]
    bt = block_tables.long().clamp(0, n_pages - 1)
    k = k_pages[bt].reshape(b, nb * page, *k_pages.shape[2:])
    v = v_pages[bt].reshape(b, nb * page, *v_pages.shape[2:])
    return flash_chunk_ref(q, k, v, q_offset, q_len, kv_len, scale)


def permute_tokens_ref(x, src_tok):
    """x (T, h), src_tok (N,) int32 -> (N, h); src_tok[i] < 0 yields 0."""
    rows = x[src_tok.long().clamp_min(0)]
    return torch.where(src_tok[:, None] >= 0, rows, torch.zeros_like(rows))


def permute_tokens_ragged_ref(x, src_tok, total, *, seg_stride=None):
    """Segment-aware ``permute_tokens``.  Validity rides in ``src_tok``
    (rows outside the per-segment prefixes carry -1), so the dense gather
    is the answer; ``total`` / ``seg_stride`` only tell the kernel which
    tiles it may skip."""
    del total, seg_stride
    return permute_tokens_ref(x, src_tok)


def unpermute_tokens_ref(buf, src_slot, weights):
    """buf (M, h), src_slot (T, k) int32, weights (T, k) -> (T, h).
    f32-accumulated weighted combine; slots with src_slot < 0 add 0."""
    t, k = src_slot.shape
    rows = buf[src_slot.long().clamp_min(0).reshape(-1)].float()
    w = torch.where(src_slot >= 0, weights.float(),
                    torch.zeros((), device=buf.device))
    out = (rows.reshape(t, k, -1) * w[:, :, None]).sum(1)
    return out.to(buf.dtype)


__all__ = ["top_k_first", "topk_gate_ref", "moe_gemm_ref",
           "grouped_gemm_ref", "flash_chunk_ref", "flash_decode_ref",
           "flash_chunk_paged_ref", "permute_tokens_ref",
           "permute_tokens_ragged_ref", "unpermute_tokens_ref"]
