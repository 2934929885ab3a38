"""The flash kernels' streaming route (the bf16 forward from head_dim 320,
the bf16 backward and fp32 from 192, every head dim above 512) as the CPU
tests mirror it (no counterpart in paddle_tpu/): its tiling, read from
csrc/flash_fwd.cu (`fwd_st_wmax`, `FWD_ST_BKV`), csrc/flash_bwd.cu
(`dq_st_wmax`, `DQ_ST_BO`, `DKV_ST_WMAX`, `dkv_st_bo`) and
csrc/flash_stream.cuh (`Chunk`, `groups_of`, `Split`, `warpgroups`), the
tile ranges its blocks walk, and its products over the head dim chunk by
chunk. A block owns 64 rows and, in design (a), one column group of its
output; in design (b) two, a warpgroup each, which share S (and dP), each
forming the partial products over its share of the chunks, summed in
warpgroup order. The kernels take (b) at head dims up to 512 where the
output has more than one group and either the head dim is above 320 or
(a)'s grid would fill more than one wave of the card's SMs (a run-time
choice; `warpgroups` says where (b) is allowed)."""

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


#: the widest column group with two warpgroups a block where it differs
#: from TILING's: the fp32 forward's and dQ's accumulators (128 columns)
SPLIT_WMAX = {("fwd", "float32"): 128, ("dq", "float32"): 128}


def warpgroups(kernel, dtype, d):
    """Column groups (warpgroups) a block where design (b) may run: 2 where
    the output has more than one group at head dims up to 512 (fp32 dK/dV
    only up to 320, where its own tiles stay resident), else 1."""
    n_groups = groups(d, TILING[kernel][dtype][0])[0]
    if kernel == "dkv" and dtype == "float32" and d > 320:
        return 1
    return 2 if n_groups > 1 and d <= 512 else 1


def plan(kernel, dtype, d, wgs):
    """(G, WG) of `kernel`'s output columns with wgs warpgroups a block."""
    wmax = TILING[kernel][dtype][0]
    if wgs == 2:
        wmax = SPLIT_WMAX.get((kernel, dtype), wmax)
    return groups(d, wmax)


def split(n_chunks, wgs):
    """Each warpgroup's share of the head dim's chunk tiles, (first chunk,
    count): ceil(n_chunks / wgs) each, the last what is left."""
    per = -(-n_chunks // wgs)
    return [(min(n_chunks, w * per), min(n_chunks, (w + 1) * per)
             - min(n_chunks, w * per)) for w in range(wgs)]


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


def chunked(a, b, chunk, wgs=1):
    """a b^T summed over the head dim one chunk tile of `chunk` columns at a
    time, as chunk_nt accumulates it, and with wgs warpgroups each over its
    `split` share, the partial sums added in warpgroup order: [..., m, d] x
    [..., n, d] -> [..., m, n]."""
    *lead, m, d = a.shape
    n = b.shape[-2]
    ac = a.reshape(*lead, m, d // chunk, chunk).transpose(-3, -2)
    bc = b.reshape(*lead, n, d // chunk, chunk).transpose(-3, -2)
    parts = ac @ bc.transpose(-1, -2)
    total = 0.0
    for c0, count in split(d // chunk, wgs):
        total = total + parts[..., c0:c0 + count, :, :].sum(-3)
    return total
