"""The flash kernels' streaming route (head_dim above 512) as the CPU tests
mirror it (no counterpart in paddle_tpu/): its tiling, read from
csrc/flash_fwd.cu (`fwd_st_wmax`, `FWD_ST_BKV`), csrc/flash_bwd.cu
(`dq_st_wmax`, `DQ_ST_BO`, `DKV_ST_WMAX`, `dkv_st_bo`) and
csrc/flash_stream.cuh (`Chunk`, `groups_of`), and the tile ranges its
blocks walk. A block owns 64 rows."""

#: by kernel and dtype: (the widest column group of the output a block
#: owns, the other side's rows a step)
TILING = {"fwd": {"bfloat16": (256, 64), "float32": (192, 64)},
          "dq": {"bfloat16": (256, 32), "float32": (192, 32)},
          "dkv": {"bfloat16": (128, 32), "float32": (128, 16)}}
#: columns of a chunk tile by dtype
CHUNK = {"bfloat16": 64, "float32": 32}
ROWS = 64


def groups(d, wmax):
    """(G, WG): G = ceil(d / wmax) column groups of WG = d / G rounded up to
    64 columns, the last one d - (G - 1) WG wide."""
    g = -(-d // wmax)
    return g, -(-(-(-d // g)) // 64) * 64


def kv_tiles(q0, step, s, causal, window):
    """First rows of the kv tiles of `step` rows that the query tile of
    ROWS rows from q0 sees some key of."""
    if not causal:
        return range(0, s, step)
    begin = max(0, q0 - (window - 1)) // step if window else 0
    return range(begin * step, ((q0 + ROWS - 1) // step + 1) * step, step)


def q_tiles(k0, step, s, causal, window):
    """First rows of the query tiles of `step` rows with some row that sees
    a key of the kv tile of ROWS rows from k0."""
    if not causal:
        return range(0, s, step)
    end = s // step
    if window:
        end = min(end, (k0 + ROWS - 1 + window - 1) // step + 1)
    return range(k0 // step * step, end * step, step)
