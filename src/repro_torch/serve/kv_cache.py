"""Paged KV cache — the paper's pool allocator (§4.3) for serving (port of
``repro.serve.kv_cache``).

KV *pages* (``page_size`` tokens × all layers) come from a preallocated
pool with an array-based free-list stack:

  alloc  = pop from free stack      O(1)
  free   = push page ids back       O(1) per page (vectorized for a sequence)
  lookup = block_table[seq, token // page_size]

The allocator's integers (free stack, ``n_free``, block table,
``seq_len``) follow the reference operation for operation, so the same
admit/append/release sequence leaves them equal. Two differences of form:
the state is updated in place and returned (the reference returns a new
pytree; at full width a copy of the pages per token would move the whole
pool), and the reference's ``lax.cond`` is a Python branch.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..models.layers import torch_dtype


@dataclasses.dataclass(frozen=True)
class PagedCacheSpec:
    n_layers: int
    n_kv_heads: int
    d_head: int
    page_size: int = 16
    n_pages: int = 1024
    max_seqs: int = 64
    max_pages_per_seq: int = 256
    dtype: str = "bfloat16"

    @property
    def _dt(self) -> torch.dtype:
        return torch_dtype(self.dtype)


@dataclasses.dataclass
class PagedCacheState:
    k_pages: torch.Tensor       # (L, P, page, Hkv, Dh)
    v_pages: torch.Tensor
    free_stack: torch.Tensor    # (P,) int32 page ids; valid entries [0, n_free)
    n_free: torch.Tensor        # () int32
    block_table: torch.Tensor   # (max_seqs, max_pages_per_seq) int32, -1 empty
    seq_len: torch.Tensor       # (max_seqs,) int32
    seq_active: torch.Tensor    # (max_seqs,) bool


def init_cache(spec: PagedCacheSpec, device: DeviceLike = None
               ) -> PagedCacheState:
    """An empty pool on ``device`` (None → the CUDA card)."""
    dev = resolve_device(device)
    shape = (spec.n_layers, spec.n_pages, spec.page_size, spec.n_kv_heads,
             spec.d_head)
    i32 = dict(dtype=torch.int32, device=dev)
    return PagedCacheState(
        k_pages=torch.zeros(shape, dtype=spec._dt, device=dev),
        v_pages=torch.zeros(shape, dtype=spec._dt, device=dev),
        free_stack=torch.arange(spec.n_pages, **i32),
        n_free=torch.tensor(spec.n_pages, **i32),
        block_table=torch.full((spec.max_seqs, spec.max_pages_per_seq), -1,
                               **i32),
        seq_len=torch.zeros((spec.max_seqs,), **i32),
        seq_active=torch.zeros((spec.max_seqs,), dtype=torch.bool,
                               device=dev),
    )


def admit_sequence(spec: PagedCacheSpec, st: PagedCacheState, slot: int,
                   prompt_len: int) -> Tuple[PagedCacheState, torch.Tensor]:
    """Reserve pages for a prompt of ``prompt_len`` tokens in ``slot``.

    Returns (state, ok () bool). ok=False (state unchanged) if the pool
    lacks pages or the slot is taken — the caller queues the request.
    """
    need = (int(prompt_len) + spec.page_size - 1) // spec.page_size
    ok = (need <= st.n_free) & ~st.seq_active[slot]
    if bool(ok):
        dev = st.free_stack.device
        idx = torch.arange(spec.max_pages_per_seq, dtype=torch.int32,
                           device=dev)
        take = idx < need
        # pop `need` pages from the top of the stack
        stack_pos = (st.n_free - 1 - idx).clamp(min=0).long()
        pages = torch.where(take, st.free_stack[stack_pos],
                            torch.full_like(idx, -1))
        st.block_table[slot] = torch.where(take, pages, st.block_table[slot])
        st.n_free -= need
        st.seq_len[slot] = int(prompt_len)
        st.seq_active[slot] = True
    return st, ok


def release_sequence(spec: PagedCacheSpec, st: PagedCacheState,
                     slot: int) -> PagedCacheState:
    """Free all pages of a finished sequence (O(pages), vectorized)."""
    row = st.block_table[slot].clone()
    held = row >= 0
    n_rel = held.sum(dtype=torch.int32)
    # push pages onto the stack: positions n_free .. n_free+n_rel-1
    dst = st.n_free + torch.cumsum(held, 0, dtype=torch.int32) - 1
    st.free_stack[dst[held].long()] = row[held]
    st.n_free += n_rel
    st.block_table[slot] = -1
    st.seq_len[slot] = 0
    st.seq_active[slot] = False
    return st


def append_token(spec: PagedCacheSpec, st: PagedCacheState,
                 k_new: torch.Tensor, v_new: torch.Tensor
                 ) -> Tuple[PagedCacheState, torch.Tensor]:
    """Write one token of KV for every active slot; grow pages when needed.

    k_new/v_new: (L, max_seqs, Hkv, Dh). Returns (state, wrote
    (max_seqs,) bool).
    """
    dev = st.seq_len.device
    rows = torch.arange(spec.max_seqs, device=dev)
    pos = st.seq_len
    page_idx = (pos // spec.page_size).long()
    off = (pos % spec.page_size).long()
    needs_page = (off == 0) & st.seq_active
    n_need = needs_page.sum(dtype=torch.int32)
    ok = n_need <= st.n_free

    # one page per slot needing growth (prefix-sum slot reservation, §3.2)
    order = torch.cumsum(needs_page, 0, dtype=torch.int32) - 1
    stack_pos = (st.n_free - 1 - order).clamp(0, spec.n_pages - 1).long()
    grow = needs_page & ok
    new_pages = torch.where(grow, st.free_stack[stack_pos],
                            torch.full_like(order, -1))
    # a page index past the table is dropped on write and clamped on read,
    # as the reference's scatter and gather do
    in_table = page_idx < spec.max_pages_per_seq
    col = page_idx.clamp(max=spec.max_pages_per_seq - 1)
    sel = grow & in_table
    st.block_table[rows[sel], col[sel]] = new_pages[sel]
    st.n_free -= torch.where(ok, n_need, torch.zeros_like(n_need))

    phys = st.block_table[rows, col]
    write = st.seq_active & (phys >= 0) & ok
    # only the written slots are stored: the reference also scatters the
    # old values back for the others, which is the same except where an
    # idle slot's parked index collides with a written page
    pw, ow = phys[write].long(), off[write]
    st.k_pages[:, pw, ow] = k_new[:, write].to(st.k_pages.dtype)
    st.v_pages[:, pw, ow] = v_new[:, write].to(st.v_pages.dtype)
    st.seq_len += write.to(torch.int32)
    return st, write


def gather_kv(spec: PagedCacheSpec, st: PagedCacheState, layer: int,
              slot: int, s_max: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Materialize (s_max, Hkv, Dh) K/V for one sequence (attention view)."""
    n_pg = s_max // spec.page_size
    pages = st.block_table[slot, :n_pg].clamp(min=0).long()
    k = st.k_pages[layer, pages].reshape(s_max, spec.n_kv_heads, spec.d_head)
    v = st.v_pages[layer, pages].reshape(s_max, spec.n_kv_heads, spec.d_head)
    valid = torch.arange(s_max, device=pages.device) < st.seq_len[slot]
    return k, v, valid
