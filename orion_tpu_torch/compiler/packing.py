"""Packing: network weights -> SIMD slot diagonals.

Counterpart of `orion_tpu/compiler/packing.py` for the layers of this slice
(Linear, BatchNorm1d): the same code, built on the multiplexed address map
`mux_slots`.  Convolution packing is a later slice.

Layout conventions:
  * row-major flattening of the FHE grid (Cm, Hm, Wm);
  * a batch of N examples occupies N consecutive copies of the grid;
  * diagonal d of an (h x slots) block B satisfies
      (B v)[j] = sum_d diag_d[j] * v[(j + d) % slots],  j < slots,
    rows replicated period-h when h < slots (hybrid embedding).
"""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp


# ------------------------------------------------------------------ #
#  The multiplexed address map                                       #
# ------------------------------------------------------------------ #

def mux_slots(c, y, x, gap: int, grid) -> np.ndarray:
    """Flat FHE-grid positions of logical elements (c, y, x).

    `grid` is the stored shape (Cm, Hm, Wm); inputs broadcast together.
    Entries whose stored pixel falls outside the grid get -1 (callers use
    this to drop out-of-bounds taps, i.e. zero padding).
    """
    Cm, Hm, Wm = grid
    g2 = gap * gap
    cm, sub = np.divmod(np.asarray(c), g2)
    dy, dx = np.divmod(sub, gap)
    ys = np.asarray(y) * gap + dy
    xs = np.asarray(x) * gap + dx
    flat = (cm * Hm + ys) * Wm + xs
    ok = (ys >= 0) & (ys < Hm) & (xs >= 0) & (xs < Wm) & (cm < Cm)
    return np.where(ok, flat, -1)


def _batched(matrix: sp.spmatrix, batch: int) -> sp.csr_matrix:
    """A batch of examples = a block-diagonal stack of the same transform."""
    if batch == 1:
        return matrix.tocsr()
    return sp.block_diag([matrix] * batch, format="csr")


# ------------------------------------------------------------------ #
#  Linear -> sparse matrix                                           #
# ------------------------------------------------------------------ #

def linear_matrix(layer) -> sp.csr_matrix:
    """Dense weight as a sparse matrix over the (possibly multiplexed)
    input grid.  After a Flatten of a spatial tensor, weight column
    (ci, y, x) must be read from that element's multiplexed slot."""
    if len(layer.input_shape) == 2:
        batch = layer.input_shape[0]
        mat = sp.csr_matrix(np.asarray(layer.on_weight, np.float64))
    else:
        batch, Ci, Hi, Wi = layer.input_shape
        grid = layer.fhe_input_shape[1:]
        c, y, x = np.indices((Ci, Hi, Wi))
        pos = mux_slots(c, y, x, layer.input_gap, grid).reshape(-1)
        w = np.asarray(layer.on_weight, np.float64)  # (out, Ci*Hi*Wi)
        out_idx = np.repeat(np.arange(w.shape[0]), pos.size)
        col_idx = np.tile(pos, w.shape[0])
        vals = w.reshape(-1)
        keep = (col_idx >= 0) & (vals != 0)
        mat = sp.coo_matrix(
            (vals[keep], (out_idx[keep], col_idx[keep])),
            shape=(w.shape[0], int(np.prod(grid))))
    return _batched(mat, batch)


def construct_linear_bias(layer) -> np.ndarray:
    batch = layer.input_shape[0]
    return np.tile(np.asarray(layer.on_bias, dtype=np.float64), batch)


# ------------------------------------------------------------------ #
#  Generalised-diagonal extraction                                   #
# ------------------------------------------------------------------ #

def extract_diagonals(matrix: sp.spmatrix, slots: int, embed_method: str,
                      is_last_layer: bool):
    """Slice a sparse matrix into (slots x slots) blocks of generalised
    diagonals, straight from the COO triplets.

    Returns ({(block_row, block_col): {d: vec}}, output_rotations).

    Diagonal layout, one formula for both embeddings: diagonal indices
    range over [0, height); entry (rr, cc) of a block sits on diagonal
    d = (cc - rr) mod height at position j = (cc - d) mod slots.  Row rr is
    thereby replicated every `height` positions, each replica j covering
    the column window [j, j+height) — so for height == slots the replica is
    unique and d is the classic generalised diagonal, while for the hybrid
    embedding (single short block row, height = 2^ceil(log2(rows))) the
    caller sums the window partials with log2(slots/height) rotations.
    The last layer stays square so replicated partials never reach the
    user's decrypted output.
    """
    mh, mw = matrix.shape
    n_brow = math.ceil(mh / slots)
    n_bcol = math.ceil(mw / slots)

    hybrid = (n_brow == 1 and embed_method == "hybrid"
              and not is_last_layer)
    height = 1 << max(0, (mh - 1)).bit_length() if hybrid else slots
    out_rots = int(math.log2(slots // height)) if hybrid else 0

    coo = matrix.tocoo()
    coo.sum_duplicates()
    coo.eliminate_zeros()
    br, rr = np.divmod(coo.row, height)
    bc, cc = np.divmod(coo.col, slots)
    d = (cc - rr) % height
    j = (cc - d) % slots

    blocks: dict[tuple, dict[int, np.ndarray]] = {
        (i, jj): {} for i in range(n_brow) for jj in range(n_bcol)}
    group = (br * n_bcol + bc) * height + d
    order = np.argsort(group, kind="stable")
    cuts = np.flatnonzero(np.diff(group[order])) + 1
    for sel in np.split(order, cuts):
        if sel.size == 0:
            continue
        key = (int(br[sel[0]]), int(bc[sel[0]]))
        vec = np.zeros(slots)
        vec[j[sel]] = coo.data[sel]
        blocks[key][int(d[sel[0]])] = vec
    for key, diags in blocks.items():
        if not diags:
            diags[0] = np.zeros(slots)
    return blocks, out_rots


# ------------------------------------------------------------------ #
#  Layer-level entry points                                          #
# ------------------------------------------------------------------ #

def pack_linear(layer, last: bool):
    return extract_diagonals(
        linear_matrix(layer), layer.scheme.params.slots,
        layer.scheme.params.embedding_method, last)


# ------------------------------------------------------------------ #
#  BatchNorm packing                                                 #
# ------------------------------------------------------------------ #

def pack_bn1d(bn):
    batch = bn.input_shape[0]
    mean = np.tile(np.asarray(bn.on_running_mean, np.float64).ravel(), batch)
    inv_std = np.tile(1.0 / np.sqrt(bn.on_running_var + bn.eps), batch)
    weight = bias = None
    if bn.affine:
        weight = np.tile(np.asarray(bn.on_weight, np.float64).ravel(), batch)
        bias = np.tile(np.asarray(bn.on_bias, np.float64).ravel(), batch)
    return mean, inv_std, weight, bias
