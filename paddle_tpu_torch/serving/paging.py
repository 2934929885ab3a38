"""Paged KV cache: the block pool behind ``FLAGS_paged_kv``.

Ports paddle_tpu/serving/paging.py: ``PagePoolFullError``,
``gather_dense``, ``scatter_cols``, ``_PrefixEntry`` and ``PagePool``.
Physical K/V lives in a pool of fixed-size frames (``[n_blocks, L, KVh,
block_size, hd]`` a side, frame 0 the null frame that no session owns);
each slot holds a block table of frame indices. A decode step gathers the
pool through the tables into the dense ``[L, B, KVh, T, hd]`` layout the
unchanged decode math takes, and writes each row's new column back, so
the paged engine's tokens are those of the dense engine.

- **Whole-budget reservation**: a session's frames
  (``ceil(min(T, prompt + max_new) / block_size)``) are reserved at
  admission, before any prefill; a pool that cannot cover them raises
  :class:`PagePoolFullError` with nothing changed, and the engine requeues
  the request.
- **Shared prefixes**: a registered prefix's full blocks are written into
  the pool once; every session on that prefix maps its leading table
  entries to the same frames (refcounted). A partial boundary block is
  copied into a private frame at admission (copy on write).
- **Cold pages**: a prefix frame that no session maps, untouched for
  ``cold_after`` sweeps, is compressed to an int8 host page with the row
  codec (distributed/compress.py) and its frame freed; the next admission
  on that prefix decompresses it into a fresh frame, within the codec's
  ``absmax / 254`` a row.

Frames are PyTorch tensors on the engine's device, updated in place (the
reference threads new arrays through its programs). The free list pops
frame 1 first, as the reference's does, so the same operations give the
same tables. ``AdapterRegistry`` keeps the named multi-LoRA adapter slots
of the paged engine (LRU eviction, pinning). The reference's monitor
counters count into the default registry: ``kv_page_blocks_total{state}``
(hot: a frame allocated; cold: a frame compressed away),
``kv_page_cow_total`` and ``serving_adapter_total{event}`` (load, evict,
hit). Not ported: the reference's handoff-schema validation of
``admit_row`` (it reads the analysis package).
"""
import numpy as np
import torch

from .. import monitor as _monitor
from ..core.device import resolve_device
from ..distributed import compress as _compress

__all__ = ["AdapterRegistry", "PagePool", "PagePoolFullError",
           "gather_dense", "scatter_cols"]


# pool metrics in the default registry (process-wide, like the serving
# counters; per-pool gauges live on PagePool.stats())
_BLOCKS = _monitor.counter(
    "kv_page_blocks_total",
    "KV pool block transitions: hot = a frame allocated (admission, "
    "prefix registration, cold-page decompression), cold = a frame "
    "compressed to an int8 host page and freed",
    labelnames=("state",))
_COW = _monitor.counter(
    "kv_page_cow_total",
    "copy-on-write boundary blocks: a session admitted on a shared "
    "prefix whose length is not block-aligned copies the partial block "
    "to a private frame before writing its own tokens")
_ADAPTER = _monitor.counter(
    "serving_adapter_total",
    "multi-LoRA adapter registry events (load = factors written into a "
    "device slot, evict = LRU or explicit eviction freed a slot, hit = "
    "a submitted request resolved an already-loaded adapter)",
    labelnames=("event",))


class PagePoolFullError(RuntimeError):
    """Block reservation refused: the pool has fewer free frames than the
    session's whole budget. Raised before any prefill or table change —
    admission backpressure, not a fault."""


def gather_dense(kp, vp, tables):
    """The pool read through per-slot block tables into the dense cache
    layout. ``kp``/``vp`` [NB, L, KVh, bs, hd]; ``tables`` int [B, maxb].
    Returns new tensors ``(kc, vc)`` [L, B, KVh, maxb * bs, hd] (a decode
    step writes into these copies, never into the pool). Entries of 0 read
    the null frame: columns no live query attends."""
    tables = tables.long()

    def one(pool):
        g = pool[tables]                       # [B, maxb, L, KVh, bs, hd]
        B, maxb, L, KVh, bs, hd = g.shape
        return g.permute(2, 0, 3, 1, 4, 5).reshape(L, B, KVh, maxb * bs, hd)

    return one(kp), one(vp)


def scatter_cols(kp, vp, kc, vc, tables, pos):
    """Write each row's column ``pos[b]`` of the post-step dense cache back
    into its pool frame, in place (one column of :func:`gather_dense`,
    inverted).

    A slot with no session has an all-null table row, so its junk write
    lands in frame 0; several such rows may hit the same place of frame 0,
    which is never read as data. A slot finished at "capacity" keeps
    ``pos == T`` until its next admission: its column is clamped to T - 1
    (the reference's gather clamps it the same way), and still lands in
    frame 0."""
    bs = kp.shape[3]
    T = kc.shape[3]
    tables = tables.long()
    pos = pos.long().clamp(max=T - 1)
    rows = torch.arange(tables.shape[0], device=tables.device)
    frames = tables[rows, pos // bs]
    off = pos % bs
    kp[frames, :, :, off, :] = kc[:, rows, :, pos, :]    # [B, L, KVh, hd]
    vp[frames, :, :, off, :] = vc[:, rows, :, pos, :]


class _PrefixEntry:
    __slots__ = ("frames", "cold", "last_use")

    def __init__(self, frames):
        self.frames = list(frames)   # hot frame id, or None while cold
        self.cold = {}               # block idx -> (kq, ks, vq, vs) on host
        self.last_use = 0


def _cold_bytes(kq, ks, vq, vs):
    return kq.numel() + ks.numel() * 4 + vq.numel() + vs.numel() * 4


class PagePool:
    """The physical KV frames and the per-slot block tables (host-side
    bookkeeping in numpy, frames on ``device``).

    ``dims`` = ``(L, KVh, hd)`` of the served config; ``max_seq`` must be
    a multiple of ``block_size``. Frame 0 is the null frame: zeros at
    first, never allocated, the target of every unreserved table entry.
    ``device``: ``cuda`` unless the caller names another (the engine
    passes its model's)."""

    def __init__(self, dims, dtype, block_size, n_blocks, max_batch,
                 max_seq, cold_after=None, device=None):
        L, KVh, hd = dims
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if max_seq % block_size != 0:
            raise ValueError(
                f"max_seq={max_seq} must be a multiple of "
                f"block_size={block_size} (the block-table gather "
                "reconstructs the dense cache as maxb*bs columns)")
        if n_blocks < 2:
            raise ValueError(
                f"n_blocks must be >= 2 (frame 0 is the null frame), "
                f"got {n_blocks}")
        self.dims = (L, KVh, hd)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.bs = int(block_size)
        self.n_blocks = int(n_blocks)
        self.maxb = max_seq // self.bs
        self.max_seq = int(max_seq)
        self.cold_after = cold_after
        self.kp = torch.zeros((n_blocks, L, KVh, self.bs, hd), dtype=dtype,
                              device=self.device)
        self.vp = torch.zeros_like(self.kp)
        self.refs = np.zeros(n_blocks, np.int64)
        self.refs[0] = 1                       # null frame: held forever
        self._free = list(range(n_blocks - 1, 0, -1))  # pop() -> frame 1 first
        self.tables = np.zeros((max_batch, self.maxb), np.int32)
        self._nres = np.zeros(max_batch, np.int64)
        self._nshared = np.zeros(max_batch, np.int64)
        self._prefixes = {}
        self._sweeps = 0
        self._cold_pages = 0
        self._cold_bytes = 0

    # -- geometry ---------------------------------------------------------
    @property
    def block_bytes(self):
        """Device bytes of ONE block across both sides (k + v)."""
        L, KVh, hd = self.dims
        return 2 * L * KVh * self.bs * hd * self.dtype.itemsize

    def blocks_for(self, n_cols):
        """Whole-budget block count for a session spanning ``n_cols``."""
        return -(-int(n_cols) // self.bs)

    def free_blocks(self):
        return len(self._free)

    def tables_device(self):
        """A copy of the block tables on the pool's device."""
        return torch.tensor(self.tables, device=self.device)

    # -- allocation -------------------------------------------------------
    def _alloc(self, n):
        if n > len(self._free):
            raise PagePoolFullError(
                f"KV page pool exhausted: need {n} free block(s), have "
                f"{len(self._free)} of {self.n_blocks - 1} — admission "
                "backs off until sessions finish (raise page_blocks= to "
                "provision more)")
        frames = [self._free.pop() for _ in range(n)]
        for f in frames:
            self.refs[f] = 1
        if n:
            _BLOCKS.labels(state="hot").inc(n)
        return frames

    def _deref(self, frame):
        f = int(frame)
        if f == 0:
            return
        self.refs[f] -= 1
        if self.refs[f] == 0:
            self._free.append(f)

    def _write_blocks(self, frames, first, kc_row, vc_row):
        """Blocks ``first .. first + len(frames)`` of dense rows
        [L, KVh, T, hd] into ``frames``."""
        if not frames:
            return
        L, KVh, hd = self.dims
        idx = torch.as_tensor(frames, dtype=torch.long, device=self.device)
        for pool, row in ((self.kp, kc_row), (self.vp, vc_row)):
            b = row.reshape(L, KVh, self.maxb, self.bs, hd).permute(
                2, 0, 1, 3, 4)
            pool[idx] = b[first:first + len(frames)].to(self.dtype)

    def reserve(self, slot, n_cols, shared_frames=(), cow=False):
        """Reserve the slot's WHOLE block budget for a session spanning
        ``n_cols`` cache columns: leading table entries map to
        ``shared_frames`` (refcounted prefix blocks), the rest get private
        frames (a prefix's partial boundary block among them: the copy on
        write, which ``cow=True`` counts in ``kv_page_cow_total``). Raises
        :class:`PagePoolFullError` before any change when the pool cannot
        cover the private part."""
        need = self.blocks_for(n_cols)
        n_shared = len(shared_frames)
        if n_shared > need:
            raise ValueError(
                f"slot {slot}: {n_shared} shared frames exceed the "
                f"{need}-block budget for {n_cols} columns")
        if self._nres[slot]:
            raise RuntimeError(f"slot {slot} already holds a reservation")
        priv = self._alloc(need - n_shared)    # raises before any change
        for j, f in enumerate(shared_frames):
            self.tables[slot, j] = f
            self.refs[int(f)] += 1
        for j, f in enumerate(priv):
            self.tables[slot, n_shared + j] = f
        self._nres[slot] = need
        self._nshared[slot] = n_shared
        if cow:
            _COW.inc()
        return need

    def free_slot(self, slot):
        """Release a finished session's frames (shared frames deref; a
        prefix frame survives on its registry pin)."""
        for j in range(int(self._nres[slot])):
            self._deref(self.tables[slot, j])
        self.tables[slot, :] = 0
        self._nres[slot] = 0
        self._nshared[slot] = 0

    def admit_row(self, slot, kc_row, vc_row):
        """Copy a prefilled dense row [L, KVh, T, hd] into the slot's
        PRIVATE frames (the reserved entries past the shared prefix). The
        copy-on-write boundary block is one of them: the row holds the
        prefix at its columns, so the private boundary frame gets prefix
        and session tokens in one write."""
        L, KVh, hd = self.dims
        want = (L, KVh, self.max_seq, hd)
        if tuple(kc_row.shape) != want or tuple(vc_row.shape) != want:
            raise ValueError(f"admit_row: rows must be {list(want)}, got "
                             f"{list(kc_row.shape)} / {list(vc_row.shape)}")
        lo, hi = int(self._nshared[slot]), int(self._nres[slot])
        self._write_blocks([int(f) for f in self.tables[slot, lo:hi]], lo,
                           kc_row, vc_row)

    # -- shared prefixes + cold pages -------------------------------------
    def put_prefix(self, key, kc_row, vc_row, prefix_len):
        """Write a registered prefix's FULL blocks into the pool once
        (pinned by the registry ref). Returns the number of shared blocks;
        a prefix shorter than one block shares nothing (its content rides
        each session's private boundary frame)."""
        if key in self._prefixes:
            raise ValueError(f"prefix {key!r} already registered")
        n_full = int(prefix_len) // self.bs
        frames = self._alloc(n_full)           # raises before any change
        self._write_blocks(frames, 0, kc_row, vc_row)
        entry = _PrefixEntry(frames)
        entry.last_use = self._sweeps
        self._prefixes[key] = entry
        return n_full

    def prefix_frames(self, key):
        """The shared frame list of a registered prefix, decompressing any
        cold page back into a fresh frame (the touch path). Raises
        :class:`PagePoolFullError` when decompression cannot get a frame.
        ``None`` for an unknown key."""
        entry = self._prefixes.get(key)
        if entry is None:
            return None
        entry.last_use = self._sweeps
        if entry.cold:
            need = len(entry.cold)
            if need > len(self._free):
                raise PagePoolFullError(
                    f"cold-page decompression for prefix {key!r} needs "
                    f"{need} free block(s), have {len(self._free)}")
            for idx in sorted(entry.cold):
                kq, ks, vq, vs = entry.cold.pop(idx)
                (f,) = self._alloc(1)
                dev = self.device
                self.kp[f] = _compress.dequantize_rows(
                    kq.to(dev), ks.to(dev), self.dtype)
                self.vp[f] = _compress.dequantize_rows(
                    vq.to(dev), vs.to(dev), self.dtype)
                entry.frames[idx] = f
                self._cold_pages -= 1
                self._cold_bytes -= _cold_bytes(kq, ks, vq, vs)
        return list(entry.frames)

    def drop_prefix(self, key):
        """Unpin a registered prefix (its frames free once no session maps
        them; cold pages are discarded)."""
        entry = self._prefixes.pop(key)
        for f in entry.frames:
            if f is not None:
                self._deref(f)
        self._cold_pages -= len(entry.cold)
        self._cold_bytes -= sum(_cold_bytes(*page)
                                for page in entry.cold.values())

    def sweep(self):
        """One cold-compression round (the engine calls it every step): a
        prefix frame that no live session maps, untouched for
        ``cold_after`` sweeps, becomes an int8 host page and its frame is
        freed. Returns the number of frames compressed."""
        self._sweeps += 1
        if self.cold_after is None:
            return 0
        compressed = 0
        for entry in self._prefixes.values():
            if self._sweeps - entry.last_use < self.cold_after:
                continue
            for idx, f in enumerate(entry.frames):
                if f is None or self.refs[f] != 1:
                    continue                   # a session still maps it
                kq, ks = (t.cpu() for t in _compress.quantize_rows(
                    self.kp[f]))
                vq, vs = (t.cpu() for t in _compress.quantize_rows(
                    self.vp[f]))
                entry.cold[idx] = (kq, ks, vq, vs)
                entry.frames[idx] = None
                self._deref(f)
                self._cold_pages += 1
                self._cold_bytes += _cold_bytes(kq, ks, vq, vs)
                compressed += 1
        if compressed:
            _BLOCKS.labels(state="cold").inc(compressed)
        return compressed

    # -- accounting -------------------------------------------------------
    def live_blocks(self):
        """Frames currently allocated (hot), null frame excluded."""
        return self.n_blocks - 1 - len(self._free)

    def bytes_in_use(self):
        """Physical KV bytes the pool holds now: hot frames at the device
        dtype plus compressed cold pages (int8 values and f32 row scales).
        Shared prefix frames count once."""
        return self.live_blocks() * self.block_bytes + self._cold_bytes

    def stats(self):
        return {
            "block_size": self.bs,
            "n_blocks": self.n_blocks,
            "max_blocks_per_slot": self.maxb,
            "free_blocks": len(self._free),
            "live_blocks": self.live_blocks(),
            "cold_pages": self._cold_pages,
            "block_bytes": self.block_bytes,
            "bytes_in_use": self.bytes_in_use(),
            "cold_bytes": self._cold_bytes,
            "prefixes": len(self._prefixes),
            "sweeps": self._sweeps,
        }


class AdapterRegistry:
    """Named multi-LoRA adapter slots with LRU eviction and pinning.

    Slot 0 is reserved (all-zero factors: base-model requests); the usable
    slots are ``1..n_slots``. The registry is bookkeeping only: the engine
    owns the stacked device factors and writes or zeroes a slot on load or
    evict."""

    def __init__(self, n_slots):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = int(n_slots)
        self._slots = {}                       # name -> slot index
        self._pinned = set()
        self._lru = []                         # oldest first
        self._free = list(range(self.n_slots, 0, -1))

    def lookup(self, name):
        """A loaded adapter's slot (touching its LRU place), else None."""
        slot = self._slots.get(name)
        if slot is not None:
            self._touch(name)
            _ADAPTER.labels(event="hit").inc()
        return slot

    def peek(self, name):
        """A loaded adapter's slot without touching the LRU order."""
        return self._slots.get(name)

    def _touch(self, name):
        if name in self._lru:
            self._lru.remove(name)
        self._lru.append(name)

    def admit(self, name, pin=False):
        """Claim a slot for ``name``: a free one if any, else the least
        recently used unpinned adapter's. Returns ``(slot, evicted_name)``
        (not None when an adapter was displaced: the engine overwrites its
        device slot and requeues its sessions). Raises RuntimeError when
        every slot is pinned."""
        if name in self._slots:
            raise ValueError(f"adapter {name!r} is already loaded")
        evicted = None
        if self._free:
            slot = self._free.pop()
        else:
            victim = next((n for n in self._lru
                           if n not in self._pinned), None)
            if victim is None:
                raise RuntimeError(
                    f"all {self.n_slots} adapter slots are pinned — "
                    "evict_adapter() one or raise max_adapters=")
            slot = self._slots.pop(victim)
            self._lru.remove(victim)
            _ADAPTER.labels(event="evict").inc()
            evicted = victim
        self._slots[name] = slot
        if pin:
            self._pinned.add(name)
        self._touch(name)
        _ADAPTER.labels(event="load").inc()
        return slot, evicted

    def evict(self, name):
        """Evict ``name`` (pinned or not); returns its slot."""
        if name not in self._slots:
            raise KeyError(f"adapter {name!r} is not loaded")
        slot = self._slots.pop(name)
        self._pinned.discard(name)
        if name in self._lru:
            self._lru.remove(name)
        self._free.append(slot)
        _ADAPTER.labels(event="evict").inc()
        return slot

    def loaded(self):
        return dict(self._slots)

    def stats(self):
        return {"n_slots": self.n_slots,
                "loaded": len(self._slots),
                "pinned": len(self._pinned),
                "free_slots": len(self._free)}
