"""Wrappers around the kernels (port of ``repro.kernels.ops``): K1's
block-sparse column map (from the stencil runs or from a Verlet pair list),
its resident-layout entry point, the fused sweep that runs it beside the
other pair kernels and its slot-order entry point, and K2's whole-sequence
attention."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from ..core import grid, morton
from ..core.lanes import Lanes
from . import block_cols as colmap
from . import collision_force as k1
from . import flash_attention as k2
from . import pair_cols

BLOCK = k1.BLOCK
SPAN = 8                 # most column blocks one stencil run may cover
_SENTINEL = 2 ** 30
# row blocks per chunk of the column-map build: bounds its scratch to
# chunk·128·9·span ids (the reference maps 64 at a time)
_COLMAP_ROW_BLOCKS = 256

Adhesion = Optional[Union[Tuple[Tuple[float, ...], ...], torch.Tensor]]


def k1_run_offsets() -> np.ndarray:
    """The 9 (dx, dy) stencil columns; each pairs with a 3-box z-run."""
    return np.array([(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
                    dtype=np.int32)


def _multi(lanes: Optional[Lanes]) -> bool:
    return lanes is not None and not lanes.solo


def lane_stride(lanes: Optional[Lanes], rows: int) -> int:
    """Packed rows per lane: a lane's C rows padded to whole 128-row
    blocks (``rows`` padded, without lanes)."""
    per = lanes.capacity if _multi(lanes) else rows
    return -(-per // BLOCK) * BLOCK


def build_block_cols(sorted_cells: torch.Tensor, starts: torch.Tensor,
                     counts: torch.Tensor, row_active: torch.Tensor,
                     dims: Tuple[int, int, int], maxb: int,
                     span: int = SPAN, lanes: Optional[Lanes] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-sparse column map: for each 128-row block, the ascending unique
    128-wide column blocks covering the 9 merged stencil z-runs of its
    *active* rows, -1 padded to ``maxb``.

    sorted_cells (N_pad, 3) int32, starts (M,) int32, counts (M,),
    row_active (N_pad,) bool. Returns ``(block_cols (N_pad/128, maxb)
    int32, overflow () bool)``; the flag fires when a row block needs more
    than ``maxb`` column blocks or one run spans more than ``span`` blocks.
    Equal, entry for entry, to the reference's map. On CUDA tensors the
    column-map kernel builds it (``block_cols.column_map``), on CPU tensors
    :func:`build_block_cols_plain`.

    ``lanes``: an ensemble's map in one call. The rows are the lanes packed
    at :func:`lane_stride` each, ``starts``/``counts`` the lanes' tables
    (L·M,) over the lane-major pool; each row block maps its own lane, so
    its column ids never reach another lane's rows, and ``overflow`` is
    (L,).
    """
    if sorted_cells.device.type == "cpu":
        return build_block_cols_plain(sorted_cells, starts, counts,
                                      row_active, dims, maxb, span, lanes)
    cols, ovf, _, _ = colmap.column_map(
        starts, counts, dims, maxb, span, n_pad=sorted_cells.shape[0],
        cells=sorted_cells, row_active=row_active,
        **({"lanes": lanes.n, "lane_rows": lanes.capacity}
           if _multi(lanes) else {}))
    return cols, ovf


def build_block_cols_plain(sorted_cells: torch.Tensor, starts: torch.Tensor,
                           counts: torch.Tensor, row_active: torch.Tensor,
                           dims: Tuple[int, int, int], maxb: int,
                           span: int = SPAN, lanes: Optional[Lanes] = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`build_block_cols` in plain PyTorch, on any device: chunks of
    row blocks, each sorting its candidate ids."""
    dev = sorted_cells.device
    n_rb = sorted_cells.shape[0] // BLOCK
    xy = torch.as_tensor(k1_run_offsets(), device=dev)
    ks = torch.arange(span, dtype=torch.int32, device=dev)
    cols = torch.empty((n_rb, maxb), dtype=torch.int32, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    multi = _multi(lanes)
    if multi:
        stride = sorted_cells.shape[0] // lanes.n
        ovf_rb = torch.zeros((n_rb,), dtype=torch.bool, device=dev)
    starts = starts.to(torch.int32)
    counts = counts.to(torch.int32)
    for b0 in range(0, n_rb, _COLMAP_ROW_BLOCKS):
        b1 = min(b0 + _COLMAP_ROW_BLOCKS, n_rb)
        nb = b1 - b0
        cell = sorted_cells[b0 * BLOCK:b1 * BLOCK]            # (R·128, 3)
        act = row_active[b0 * BLOCK:b1 * BLOCK]
        nx = cell[:, None, 0] + xy[None, :, 0]                # (R·128, 9)
        ny = cell[:, None, 1] + xy[None, :, 1]
        inside = (nx >= 0) & (nx < dims[0]) & (ny >= 0) & (ny < dims[1])
        nx = nx.clamp(0, dims[0] - 1)
        ny = ny.clamp(0, dims[1] - 1)
        z_lo = (cell[:, 2] - 1).clamp(min=0)[:, None].expand_as(nx)
        z_hi = (cell[:, 2] + 1).clamp(max=dims[2] - 1)[:, None].expand_as(nx)
        k_lo = morton.linear_encode3(nx, ny, z_lo, dims)
        k_hi = morton.linear_encode3(nx, ny, z_hi, dims)
        shift = 0
        if multi:
            # each row's own lane: its table, and its slot ids as packed rows
            lane = torch.div(torch.arange(b0 * BLOCK, b1 * BLOCK,
                                          device=dev), stride,
                             rounding_mode="floor")[:, None]
            m = counts.shape[0] // lanes.n
            k_lo, k_hi = k_lo + lane * m, k_hi + lane * m
            shift = (lane * (stride - lanes.capacity)).to(torch.int32)
        s = starts[k_lo] + shift
        e = starts[k_hi] + counts[k_hi] + shift
        n = torch.where(inside & act[:, None], e - s, torch.zeros_like(s))
        first = torch.div(s, BLOCK, rounding_mode="floor")
        last = torch.where(n > 0,
                           torch.div(s + n - 1, BLOCK, rounding_mode="floor"),
                           torch.full_like(s, -1))
        cand = first[..., None] + ks                  # (R·128, 9, span)
        ok = (n[..., None] > 0) & (cand <= last[..., None])
        cols[b0:b1], n_uniq = _ascending_unique(
            torch.where(ok, cand, torch.full_like(cand, _SENTINEL)
                        ).reshape(nb, -1), maxb)
        span_ovf = ((last - first + 1) > span).reshape(nb, -1).any(1)
        if multi:
            ovf_rb[b0:b1] = (n_uniq > maxb) | span_ovf
        else:
            ovf |= ((n_uniq > maxb) | span_ovf).any()
    if multi:
        ovf = ovf_rb.reshape(lanes.n, -1).any(1)
    return cols, ovf


def _ascending_unique(ids: torch.Tensor, maxb: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row of ``ids`` (rows, K) int32 (``_SENTINEL`` for none): the
    first ``maxb`` ascending unique ids, -1 padded, and how many there
    are."""
    ids = torch.sort(ids, dim=1).values
    uniq = torch.ones_like(ids, dtype=torch.bool)
    uniq[:, 1:] = ids[:, 1:] != ids[:, :-1]
    uniq &= ids < _SENTINEL
    pos = torch.cumsum(uniq, 1) - 1
    write = torch.where(uniq & (pos < maxb), pos,
                        torch.full_like(pos, maxb))
    out = torch.full((ids.shape[0], maxb + 1), -1, dtype=torch.int32,
                     device=ids.device)
    out.scatter_(1, write, ids)          # column maxb: dropped writes
    return out[:, :maxb], uniq.sum(1)


def build_block_cols_from_pairs(pairs: grid.PairList,
                                row_active: torch.Tensor, n_pad: int,
                                maxb: int, lanes: Optional[Lanes] = None
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-sparse column map from a Verlet pair list: for each 128-row
    block, the ascending unique ``idx // 128`` over every stored entry of
    its active rows (``row_active`` (n_pad,) bool), -1 padded to ``maxb``,
    with the overflow flag when more than ``maxb`` are needed.

    A subset of :func:`build_block_cols`'s map: a dropped block holds no
    listed candidate, so K1, which adds each row's pairs in candidate order
    and no pair outside its band, gives the same sums on either map.
    Equal, entry for entry, to the reference's. On CUDA tensors the pairs
    column-map kernel builds it (``pair_cols.column_map_from_pairs``), on
    CPU tensors :func:`build_block_cols_from_pairs_plain`.

    ``lanes``: an ensemble's list (lane-major rows, slot ids of the whole
    pool), its rows packed at :func:`lane_stride` each; the entries move
    to packed rows, so each row block maps its own lane, and ``overflow``
    is (L,).
    """
    if pairs.idx.device.type == "cpu":
        return build_block_cols_from_pairs_plain(pairs, row_active, n_pad,
                                                 maxb, lanes)
    cols, ovf, _, _ = pair_cols.column_map_from_pairs(
        pairs.idx, pairs.run_off, n_pad, maxb, row_active=row_active,
        lanes=lanes.n if _multi(lanes) else 1)
    return cols, ovf


def build_block_cols_from_pairs_plain(pairs: grid.PairList,
                                      row_active: torch.Tensor, n_pad: int,
                                      maxb: int,
                                      lanes: Optional[Lanes] = None
                                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`build_block_cols_from_pairs` in plain PyTorch, on any device:
    chunks of row blocks, each sorting its column ids. A list of no rows
    maps nothing (every entry -1, no overflow)."""
    c, p = pairs.idx.shape
    dev = pairs.idx.device
    n_rb = n_pad // BLOCK
    lane = torch.arange(p, dtype=torch.int32, device=dev)
    multi = _multi(lanes)
    if c == 0:
        return (torch.full((n_rb, maxb), -1, dtype=torch.int32, device=dev),
                torch.zeros((lanes.n,) if multi else (), dtype=torch.bool,
                            device=dev))
    cols = torch.empty((n_rb, maxb), dtype=torch.int32, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    if multi:
        stride = n_pad // lanes.n
        ovf_rb = torch.zeros((n_rb,), dtype=torch.bool, device=dev)
    for b0 in range(0, n_rb, _COLMAP_ROW_BLOCKS):
        b1 = min(b0 + _COLMAP_ROW_BLOCKS, n_rb)
        rows = torch.arange(b0 * BLOCK, b1 * BLOCK, device=dev)
        shift = 0
        if multi:
            # each packed row's lane, its pool row, and the shift of its
            # lane's slot ids to packed rows
            lane_id = torch.div(rows, stride, rounding_mode="floor")
            local = rows - lane_id * stride
            in_pool = local < lanes.capacity
            rows = lane_id * lanes.capacity + local
            shift = (lane_id * (stride - lanes.capacity)).to(
                torch.int32)[:, None]
            act = row_active[b0 * BLOCK:b1 * BLOCK] & in_pool
        else:
            act = row_active[rows] & (rows < c)
        safe = rows.clamp(max=c - 1)
        ok = (lane < pairs.run_off[safe, 9:]) & act[:, None]
        ids = torch.where(ok, torch.div(pairs.idx[safe] + shift, BLOCK,
                                        rounding_mode="floor"),
                          torch.full((), _SENTINEL, dtype=torch.int32,
                                     device=dev))
        cols[b0:b1], n_uniq = _ascending_unique(
            ids.reshape(b1 - b0, BLOCK * p), maxb)
        if multi:
            ovf_rb[b0:b1] = n_uniq > maxb
        else:
            ovf |= (n_uniq > maxb).any()
    if multi:
        ovf = ovf_rb.reshape(lanes.n, -1).any(1)
    return cols, ovf


def k1_inputs(position: torch.Tensor, diameter: torch.Tensor,
              agent_type: torch.Tensor, alive: torch.Tensor,
              active: torch.Tensor, starts: torch.Tensor,
              counts: torch.Tensor, origin: torch.Tensor, box_size: float,
              dims: Tuple[int, int, int], maxb: int = 64,
              pairs: Optional[grid.PairList] = None,
              lanes: Optional[Lanes] = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """Pad to 128, pack and map: ``(data_t (8, N_pad) f32, block_cols,
    overflow () bool, row mask (N_pad,) bool)`` — K1's inputs as the
    resident wrapper builds them, the map from the stencil runs or, with
    ``pairs``, from the pair list. On CUDA tensors one launch of the
    column-map kernel (or of the pairs column-map kernel) does all of it;
    on CPU tensors :func:`k1_inputs_plain`.

    ``lanes``: an ensemble's L lanes, each packed at :func:`lane_stride`
    rows (N_pad = L·stride) and mapped in the same launch, from the stencil
    runs or from the ensemble's pair list; the overflow is (L,)."""
    if position.device.type == "cpu":
        return k1_inputs_plain(position, diameter, agent_type, alive, active,
                               starts, counts, origin, box_size, dims, maxb,
                               pairs, lanes)
    multi = _multi(lanes)
    n_pad = (lanes.n if multi else 1) * lane_stride(lanes, position.shape[0])
    pool = (position, diameter, agent_type, alive, active)
    if pairs is not None:
        cols, ovf, data_t, sact = pair_cols.column_map_from_pairs(
            pairs.idx, pairs.run_off, n_pad, maxb, pool=pool,
            lanes=lanes.n if multi else 1)
    elif isinstance(box_size, torch.Tensor):
        # a traced box size divides (morton.cell_of), where the kernel's
        # own cell computation multiplies by a reciprocal: the cells come
        # from cell_of and the kernel maps them
        data_t, sact = _pack(position, diameter, agent_type, alive, active,
                             lanes)
        cells = morton.cell_of(_pad_rows(position, n_pad, lanes), origin,
                               box_size, dims)
        cols, ovf = build_block_cols(cells, starts, counts, sact, dims, maxb,
                                     lanes=lanes)
    else:
        cols, ovf, data_t, sact = colmap.column_map(
            starts, counts, dims, maxb, SPAN, n_pad=n_pad, pool=pool,
            origin=origin, box_size=box_size,
            lanes=lanes.n if multi else 1)
    return data_t, cols, ovf, sact


def k1_inputs_plain(position: torch.Tensor, diameter: torch.Tensor,
                    agent_type: torch.Tensor, alive: torch.Tensor,
                    active: torch.Tensor, starts: torch.Tensor,
                    counts: torch.Tensor, origin: torch.Tensor,
                    box_size: float, dims: Tuple[int, int, int],
                    maxb: int = 64, pairs: Optional[grid.PairList] = None,
                    lanes: Optional[Lanes] = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """:func:`k1_inputs` in plain PyTorch, on any device."""
    multi = _multi(lanes)
    n_pad = (lanes.n if multi else 1) * lane_stride(lanes, position.shape[0])
    data_t, sact = _pack(position, diameter, agent_type, alive, active,
                         lanes)
    if pairs is not None:
        block_cols, ovf = build_block_cols_from_pairs_plain(pairs, sact,
                                                            n_pad, maxb,
                                                            lanes)
    else:
        cells = morton.cell_of(_pad_rows(position, n_pad, lanes), origin,
                               box_size, dims)
        block_cols, ovf = build_block_cols_plain(cells, starts, counts, sact,
                                                 dims, maxb, lanes=lanes)
    return data_t, block_cols, ovf, sact


def _pad_rows(x: torch.Tensor, n_pad: int, lanes: Optional[Lanes] = None
              ) -> torch.Tensor:
    """Rows (C, ...) zero-padded to K1's ``n_pad`` rows; an ensemble's
    (L·C, ...) padded lane by lane to :func:`lane_stride` each."""
    if not _multi(lanes):
        return torch.nn.functional.pad(
            x, (0, 0) * (x.dim() - 1) + (0, n_pad - x.shape[0]))
    v = lanes.view(x)
    stride = n_pad // lanes.n
    out = torch.zeros((lanes.n, stride, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[:, :lanes.capacity] = v
    return out.reshape(n_pad, *x.shape[1:])


def _pack(position: torch.Tensor, diameter: torch.Tensor,
          agent_type: torch.Tensor, alive: torch.Tensor,
          active: torch.Tensor, lanes: Optional[Lanes] = None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's packed ``data_t`` (8, N_pad) and row mask (N_pad,), padded to
    whole 128-row blocks (an ensemble's lane by lane)."""
    c = position.shape[0]
    if _multi(lanes):
        n_pad = lanes.n * lane_stride(lanes, c)
        data_t = torch.zeros((8, n_pad), dtype=torch.float32,
                             device=position.device)
        dst = data_t.view(8, lanes.n, -1)[:, :, :lanes.capacity]
        rows = torch.cat([position.T, diameter[None].float(),
                          agent_type[None].to(torch.float32),
                          alive[None].to(torch.float32)], 0)
        dst[:k1.ROW_ALIVE + 1] = rows.reshape(k1.ROW_ALIVE + 1, lanes.n, -1)
        return data_t, _pad_rows(active & alive, n_pad, lanes)
    n_pad = -(-c // BLOCK) * BLOCK
    data_t = torch.zeros((8, n_pad), dtype=torch.float32,
                         device=position.device)
    data_t[k1.ROW_X:k1.ROW_Z + 1, :c] = position.T
    data_t[k1.ROW_DIA, :c] = diameter
    data_t[k1.ROW_TYPE, :c] = agent_type.to(torch.float32)
    data_t[k1.ROW_ALIVE, :c] = alive.to(torch.float32)
    return data_t, torch.nn.functional.pad(active & alive, (0, n_pad - c))


def collision_force_resident(position: torch.Tensor, diameter: torch.Tensor,
                             agent_type: torch.Tensor, alive: torch.Tensor,
                             active: torch.Tensor, starts: torch.Tensor,
                             counts: torch.Tensor, origin: torch.Tensor,
                             box_size: float, *, dims: Tuple[int, int, int],
                             k_rep: float = 2.0, adhesion: Adhesion = None,
                             adhesion_band: float = 0.4, maxb: int = 64,
                             pairs: Optional[grid.PairList] = None,
                             lanes: Optional[Lanes] = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """K1 over the resident grid-ordered pool: column map → kernel.

    Inputs are in grid-key order with the grid's ``(starts, counts)``
    tables. ``active`` marks the rows whose own force is needed; inactive
    rows get zero force and nnz (they still push their neighbors). Returns
    ``(force (C, 3) f32, nnz (C,) int32, column-map overflow () bool)``.
    ``box_size`` must cover the largest interaction distance, as in the
    reference. With ``pairs`` the map comes from the pair list
    (:func:`build_block_cols_from_pairs`); K1 itself is unchanged, and its
    sums equal the stencil map's while the list covers every pair in reach.
    With ``lanes`` it steps an ensemble's every lane in one column-map
    launch and one K1 launch: each lane is packed at whole row blocks, so
    no tile holds rows of two lanes and no pair crosses lanes; the
    overflow is (L,).
    """
    dev = position.device
    c = position.shape[0]
    with record_function("k1/inputs"):
        data_t, block_cols, ovf, sact = k1_inputs(
            position, diameter, agent_type, alive, active, starts, counts,
            origin, box_size, dims, maxb, pairs, lanes)
    if adhesion is not None and not isinstance(adhesion, torch.Tensor):
        adhesion = torch.tensor(adhesion, dtype=torch.float32, device=dev)
    with record_function("k1/kernel"):
        out_t = k1.collision_force(data_t, block_cols, k_rep=k_rep,
                                   adhesion=adhesion,
                                   adhesion_band=adhesion_band)
    force, nnz = _k1_outputs(out_t, sact, c, lanes)
    return force, nnz, ovf


def fused_resident_sweep(spec: grid.GridSpec, grid_env: grid.GridState,
                         channels: Dict[str, torch.Tensor],
                         kernels: Sequence[grid.PairKernel],
                         default_mask: torch.Tensor, *, origin: torch.Tensor,
                         box_size: float, k_rep: float = 2.0,
                         adhesion: Adhesion = None,
                         adhesion_band: float = 0.4,
                         chunk: Optional[int] = None, maxb: int = 64,
                         pairs: Optional[grid.PairList] = None,
                         lanes: Optional[Lanes] = None
                         ) -> tuple[Dict[str, Dict[str, torch.Tensor]],
                                    torch.Tensor]:
    """K1-backed form of ``grid.resident_apply_fused``: the kernel named
    ``"force"`` runs in K1 over the step's grid tables (its ``pair_fn`` is
    not called: K1 computes the same function), every other kernel shares
    one streamed sweep over the same tables. With ``pairs`` both take their
    candidates from the pair list: K1 its column map, the sweep its rows.

    Returns ``(results, overflow)``: results keyed like
    ``resident_apply_fused``, overflow K1's column-map flag (a zero ()
    int32 when no kernel is named ``"force"``; (L,) with ``lanes``, an
    ensemble's grid tables).
    """
    results: Dict[str, Dict[str, torch.Tensor]] = {}
    ovf = torch.zeros((), dtype=torch.int32, device=default_mask.device)
    rest = [k for k in kernels if k.name != "force"]
    fk = next((k for k in kernels if k.name == "force"), None)
    if fk is not None:
        active = fk.query_mask if fk.query_mask is not None else default_mask
        f, nnz, k_ovf = collision_force_resident(
            channels["position"], channels["diameter"],
            channels["agent_type"], channels["alive"], active,
            grid_env.starts, grid_env.counts, origin, box_size,
            dims=spec.dims, k_rep=k_rep, adhesion=adhesion,
            adhesion_band=adhesion_band, maxb=maxb, pairs=pairs,
            lanes=lanes)
        results["force"] = {"force": f, "force_nnz": nnz}
        ovf = k_ovf.to(torch.int32)
    if rest:
        results.update(grid.resident_apply_fused(
            spec, grid_env, channels, rest, default_mask, chunk, pairs))
    return results, ovf


def collision_force(position: torch.Tensor, diameter: torch.Tensor,
                    agent_type: torch.Tensor, alive: torch.Tensor,
                    active: torch.Tensor, origin: torch.Tensor,
                    box_size: morton.BoxSize, *, dims: Tuple[int, int, int],
                    k_rep: float = 2.0, adhesion: Adhesion = None,
                    adhesion_band: float = 0.4, maxb: int = 64
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 on a pool in any slot order: linear-key sort → box tables →
    :func:`collision_force_resident` → the results written back to the
    caller's slots. Same contract and returns as the resident call.

    The reference jits this wrapper with ``box_size`` as an argument, so
    its cells divide: pass a tensor for that (``morton.cell_of``). The
    write-back puts each sorted row at its slot with ``index_copy`` over
    the sort's permutation, whose indices are distinct, so no write order
    decides a value. :func:`collision_force_plain` is its plain version.
    """
    return _in_slot_order(collision_force_resident, position, diameter,
                          agent_type, alive, active, origin, box_size,
                          dims=dims, k_rep=k_rep, adhesion=adhesion,
                          adhesion_band=adhesion_band, maxb=maxb)


def collision_force_plain(position: torch.Tensor, diameter: torch.Tensor,
                          agent_type: torch.Tensor, alive: torch.Tensor,
                          active: torch.Tensor, origin: torch.Tensor,
                          box_size: morton.BoxSize, *,
                          dims: Tuple[int, int, int], k_rep: float = 2.0,
                          adhesion: Adhesion = None,
                          adhesion_band: float = 0.4, maxb: int = 64
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """:func:`collision_force` with the plain column map and K1's plain
    version, on any device."""
    def resident_plain(position, diameter, agent_type, alive, active,
                       starts, counts, origin, box_size, *, dims, k_rep,
                       adhesion, adhesion_band, maxb):
        c = position.shape[0]
        data_t, block_cols, ovf, sact = k1_inputs_plain(
            position, diameter, agent_type, alive, active, starts, counts,
            origin, box_size, dims, maxb)
        if adhesion is not None and not isinstance(adhesion, torch.Tensor):
            adhesion = torch.tensor(adhesion, dtype=torch.float32,
                                    device=position.device)
        out_t = k1.collision_force_plain(data_t, block_cols, k_rep=k_rep,
                                         adhesion=adhesion,
                                         adhesion_band=adhesion_band)
        return _k1_outputs(out_t, sact, c) + (ovf,)
    return _in_slot_order(resident_plain, position, diameter, agent_type,
                          alive, active, origin, box_size, dims=dims,
                          k_rep=k_rep, adhesion=adhesion,
                          adhesion_band=adhesion_band, maxb=maxb)


def _in_slot_order(resident_fn, position, diameter, agent_type, alive,
                   active, origin, box_size, *, dims, **kw):
    """``resident_fn`` over the pool sorted into grid-key order, its
    force and nnz written back to the caller's slots."""
    c = position.shape[0]
    m = morton.linear_size(dims)
    keys = morton.grid_sort_keys(position, alive, origin, box_size, dims)
    order = grid.counting_sort_order(keys, m).to(torch.int64)
    starts, counts = grid.box_tables(keys.index_select(0, order), m)
    f_s, nnz_s, ovf = resident_fn(
        *(x.index_select(0, order) for x in (position, diameter, agent_type,
                                             alive, active & alive)),
        starts, counts, origin, box_size, dims=dims, **kw)
    dev = position.device
    force = torch.zeros((c, 3), dtype=torch.float32,
                        device=dev).index_copy_(0, order, f_s)
    nnz = torch.zeros((c,), dtype=torch.int32,
                      device=dev).index_copy_(0, order, nnz_s)
    return force, nnz, ovf


def _k1_outputs(out_t: torch.Tensor, act: torch.Tensor, c: int,
                lanes: Optional[Lanes] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Force (C, 3) and nnz (C,) from K1's output rows (N_pad) and row mask
    ``act`` (N_pad,), zero outside ``act``; an ensemble's packed lanes are
    unpacked to the lane-major pool's rows."""
    dev = out_t.device
    if _multi(lanes):
        out_t = out_t.view(4, lanes.n, -1)[:, :, :lanes.capacity].reshape(
            4, c)
        act = act.view(lanes.n, -1)[:, :lanes.capacity].reshape(c)
    else:
        act = act[:c]
    force = torch.where(act[:, None], out_t[k1.ROW_FX:k1.ROW_FZ + 1, :c].T,
                        torch.zeros((), device=dev))
    nnz = torch.where(act, out_t[k1.ROW_NNZ, :c].to(torch.int32),
                      torch.zeros((), dtype=torch.int32, device=dev))
    return force, nnz


# ---------------------------------------------------------------------------
# K2: flash attention
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """K2 over whole sequences: every key is real (``sk_actual = Sk``) and
    the queries sit at the end of the keys (``kv_offset = Sk − Sq``).

    The TPU wrapper pads Sq and Sk to block multiples and unpads; that is a
    TPU artefact. The CUDA kernel masks its ragged tiles by bounds, so
    nothing is padded here.
    """
    sk = k.shape[2]
    return k2.flash_attention(q, k, v, causal=causal, scale=scale,
                              sk_actual=sk, kv_offset=sk - q.shape[2])
