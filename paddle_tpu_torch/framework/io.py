"""save / load of nested state (state_dicts, train states).

Ports paddle_tpu/framework/io.py (python/paddle/framework/io.py:202 save /
:292 load; fluid/dygraph/checkpoint.py:56 save_dygraph): ``save``,
``load``, ``save_dygraph``, ``load_dygraph`` and
``CheckpointCorruptError``, in the reference's file format so that files
cross between the packages:

- a pickle (protocol 4) of the object with every tensor replaced by the
  record ``{"__tensor__": True, "data": <numpy array>, "stop_gradient":
  bool, "name": str}``, dicts, lists and tuples kept, anything else as is
  (a torch tensor has no settable name: the port writes ``""`` and
  ignores the name on load);
- followed by the integrity footer ``b"PTSHA256" + sha256(payload)``,
  verified on load (a mismatch raises :class:`CheckpointCorruptError`);
  footerless files load unverified.

Tensor dtypes: fp32, fp16, fp64, the integers and bool are numpy arrays of
the same dtype, and load in either package. numpy has no bfloat16 or fp8:
the reference stores ``ml_dtypes`` arrays, which the port may not need
(the card's machine has no ``ml_dtypes``). The port stores such a tensor
as its raw bits (int16 for bfloat16, uint8 for the fp8 types) and adds
``"dtype": "<torch dtype name>"`` to the record, so it round-trips bit
for bit without ``ml_dtypes``; the reference ignores the extra key and
loads the bits as an integer tensor (``.view(ml_dtypes.bfloat16)``
recovers the values). The reference's bfloat16 record loads in the port
when ``ml_dtypes`` is importable (its bits are viewed, not converted);
without ``ml_dtypes`` the pickle cannot be read and ``load`` raises
ModuleNotFoundError naming ``ml_dtypes``, which is not a corruption
(``CheckpointSaver`` does not evict such a file).

Durability: ``save`` streams into a same-directory ``<path>.tmp.<pid>``,
appends the footer, fsyncs the file, renames it over `path` and fsyncs
the directory, so a crash leaves the old file or the new one and at worst
a stale tmp file, which the next save of the same path reclaims once its
writer is gone. ``load`` places tensors on ``device`` (``cuda`` unless the
caller passes another, through ``core.device.resolve_device``).

Each save / load counts ``checkpoint_total{op}``, ``checkpoint_ms{op}``
and ``checkpoint_bytes_total{op}``, leaves a ``checkpoint/save`` or
``checkpoint/load`` span and RecordEvent, books the ``ckpt_save`` /
``ckpt_restore`` goodput bucket (FLAGS_goodput) and passes the
``ckpt/write`` / ``ckpt/read`` failpoints. ``encryption_key=`` raises
NotImplementedError: the AES core (framework/crypto.py over a native
bridge) is not ported.
"""
import contextlib
import hashlib
import os
import pickle
import time

import numpy as np
import torch

from .. import flags as _flags
from .. import monitor as _monitor
from .. import trace as _trace
from ..core.device import resolve_device
from ..profiler import RecordEvent as _RecordEvent
from ..testing import failpoints as _fp

# integrity footer: 8-byte magic + sha256(payload), appended after the
# pickled payload. pickle stops at its STOP opcode, so a footer at the
# tail never confuses a reader that skips verification.
_FOOTER_MAGIC = b"PTSHA256"
_FOOTER_LEN = len(_FOOTER_MAGIC) + 32
_CRYPTO_MAGIC = b"PTAE"     # the reference's encrypted payload header

#: torch dtypes numpy cannot hold: stored as raw bits of this numpy dtype
_BITS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
         torch.float8_e5m2: torch.uint8}
_BY_NAME = {str(dt).replace("torch.", ""): dt for dt in _BITS}


class CheckpointCorruptError(RuntimeError):
    """The checkpoint file failed its integrity check (sha256 footer
    mismatch) or cannot be unpickled — truncated or corrupt write."""


_CKPT = _monitor.counter("checkpoint_total", "paddle.save/load calls",
                         labelnames=("op",))
_CKPT_MS = _monitor.histogram("checkpoint_ms", "save/load wall time",
                              labelnames=("op",))
_CKPT_BYTES = _monitor.counter("checkpoint_bytes_total",
                               "bytes written/read by paddle.save/load",
                               labelnames=("op",))


def _no_encryption(configs):
    if configs.get("encryption_key") is not None:
        raise NotImplementedError(
            "encryption_key= is not ported yet (it needs "
            "framework/crypto.py and its native AES bridge)")


def _goodput_bucket(name):
    """ckpt_save / ckpt_restore wall-time attribution (FLAGS_goodput): a
    null context unless the accountant is armed — one flag read per
    save / load, and the disarmed path never imports monitor/goodput.py.
    Booked here, where every checkpoint byte passes, so CheckpointSaver,
    state_dict round trips and direct save / load all attribute."""
    if not _flags.get_flag("goodput", False):
        return contextlib.nullcontext()
    from ..monitor import goodput as _goodput

    return _goodput.bucket(name)


def _record_ckpt(op, path, t0, span=None):
    nbytes = None
    try:
        nbytes = os.path.getsize(path)
    except OSError:
        pass
    if span is not None:   # trace span tagged with the payload size
        span.end(path=path, **({} if nbytes is None else {"bytes": nbytes}))
    # flight-recorder byte tag (one boolean check when the recorder is
    # off): a checkpoint in flight at wedge time shows in the ring
    _monitor.bb_note("checkpoint", op=op, path=str(path), bytes=nbytes)
    if not _monitor.is_enabled():
        return
    _CKPT.labels(op=op).inc()
    _CKPT_MS.labels(op=op).observe((time.perf_counter() - t0) * 1e3)
    if nbytes is not None:
        _CKPT_BYTES.labels(op=op).inc(nbytes)
    _monitor.log_event("checkpoint", op=op, path=path)


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        rec = {"__tensor__": True, "stop_gradient": not obj.requires_grad,
               "name": getattr(obj, "name", None) or ""}
        bits = _BITS.get(t.dtype)
        if bits is None:
            rec["data"] = t.numpy()
        else:
            rec["data"] = t.contiguous().view(bits).numpy()
            rec["dtype"] = str(t.dtype).replace("torch.", "")
        return rec
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_pack(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _tensor_of(rec, device):
    data = np.asarray(rec["data"])
    name = rec.get("dtype")
    if name is not None:              # the port's raw bits
        t = torch.from_numpy(data.copy()).view(_BY_NAME[name])
    elif data.dtype.name in _BY_NAME:   # the reference's ml_dtypes array
        dt = _BY_NAME[data.dtype.name]
        t = torch.from_numpy(data.view(np.int16 if data.itemsize == 2
                                       else np.uint8).copy()).view(dt)
    else:
        t = torch.from_numpy(np.array(data, copy=True))
    t = t.to(device)
    if not rec.get("stop_gradient", True) and t.is_floating_point():
        t.requires_grad_(True)
    return t


def _unpack(obj, device):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            return _tensor_of(obj, device)
        return {k: _unpack(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_unpack(v, device) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


class _HashingWriter:
    """File-object shim that feeds every written byte into a sha256 as the
    pickler streams, so the footer costs no second pass over the payload."""

    __slots__ = ("_f", "_h")

    def __init__(self, f, h):
        self._f = f
        self._h = h

    def write(self, b):
        self._h.update(b)
        return self._f.write(b)


def _reclaim_stale_tmps(path):
    """Remove ``<path>.tmp.<pid>`` leftovers from earlier crashed saves of
    the SAME destination whose writer process is gone. Live pids (another
    process — or thread — mid-save of this path) are left alone."""
    d = os.path.dirname(path) or "."
    prefix = os.path.basename(path) + ".tmp."
    try:
        names = os.listdir(d)
    except OSError:
        return
    for name in names:
        if not name.startswith(prefix):
            continue
        try:
            pid = int(name[len(prefix):])
            os.kill(pid, 0)
        except ValueError:
            continue            # not one of ours
        except ProcessLookupError:
            try:
                os.remove(os.path.join(d, name))
            except OSError:
                pass
        except OSError:
            continue            # e.g. EPERM: pid exists


def save(obj, path, protocol=4, **configs):
    """Atomic + verified save of `obj` (tensors anywhere in nested dicts,
    lists and tuples) to `path`: the payload streams into
    ``<path>.tmp.<pid>``, gets a sha256 integrity footer, is fsync'd, and
    only then renames over `path` (directory entry fsync'd too)."""
    _no_encryption(configs)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    _reclaim_stale_tmps(path)
    t0 = time.perf_counter()
    sp = _trace.start_span("checkpoint/save", subsystem="io")
    tmp = f"{path}.tmp.{os.getpid()}"
    with _goodput_bucket("ckpt_save"), _RecordEvent("checkpoint/save"):
        try:
            h = hashlib.sha256()
            with open(tmp, "wb") as f:
                pickle.dump(_pack(obj), _HashingWriter(f, h),
                            protocol=protocol)
                # crash window under test: payload on disk, no footer, no
                # commit — the destination must stay untouched
                _fp.failpoint("ckpt/write")
                f.write(_FOOTER_MAGIC + h.digest())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)  # atomic commit
            _fsync_dir(os.path.dirname(os.path.abspath(path)))
        except BaseException:
            # an error path reclaims its own tmp; a SIGKILL can't — the
            # CheckpointSaver startup sweep handles those
            try:
                os.remove(tmp)
            except OSError:
                pass
            sp.end(error=True)   # the failed save still leaves its span
            raise
    _record_ckpt("save", path, t0, span=sp)


def _fsync_dir(path):
    """fsync the directory entry so a just-committed rename survives power
    loss. Best-effort: some filesystems refuse to open or fsync
    directories."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _verify_footer(f, path):
    """Verify the sha256 footer if present; returns (payload length,
    footer-verified?) and leaves the file position at 0. Footerless files
    pass through unverified; a digest mismatch raises
    CheckpointCorruptError."""
    size = f.seek(0, os.SEEK_END)
    if size >= _FOOTER_LEN:
        f.seek(size - _FOOTER_LEN)
        tail = f.read(_FOOTER_LEN)
        if tail[:len(_FOOTER_MAGIC)] == _FOOTER_MAGIC:
            h = hashlib.sha256()
            f.seek(0)
            left = size - _FOOTER_LEN
            while left:
                chunk = f.read(min(1 << 20, left))
                if not chunk:
                    break
                h.update(chunk)
                left -= len(chunk)
            if h.digest() != tail[len(_FOOTER_MAGIC):]:
                raise CheckpointCorruptError(
                    f"{path}: integrity check failed — sha256 of the "
                    "payload does not match the footer (truncated or "
                    "corrupt write); restore from an older checkpoint")
            f.seek(0)
            return size - _FOOTER_LEN, True
    f.seek(0)
    return size, False


def load(path, device=None, **configs):
    """Load what :func:`save` (or the reference's ``paddle.save``) wrote;
    tensors land on `device` (``cuda`` unless another is given)."""
    _no_encryption(configs)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    sp = _trace.start_span("checkpoint/load", subsystem="io")
    try:
        with _goodput_bucket("ckpt_restore"), \
                _RecordEvent("checkpoint/load"), open(path, "rb") as f:
            _fp.failpoint("ckpt/read")
            _, verified = _verify_footer(f, path)
            if f.read(4) == _CRYPTO_MAGIC:
                raise NotImplementedError(
                    f"{path} is encrypted; decryption is not ported yet "
                    "(it needs framework/crypto.py)")
            f.seek(0)
            try:
                payload = pickle.load(f)
            except ModuleNotFoundError as e:
                if e.name != "ml_dtypes":
                    raise
                raise ModuleNotFoundError(
                    f"{path} holds ml_dtypes arrays (bfloat16 or fp8 "
                    "tensors written by the JAX package); loading them "
                    "needs the ml_dtypes package", name="ml_dtypes") from e
            except (pickle.UnpicklingError, EOFError, ValueError) as e:
                # AttributeError/MemoryError are deliberately NOT here:
                # they are as likely environmental as corruption, and a
                # corrupt classification lets CheckpointSaver's fallback
                # walk DELETE the file — when ambiguous, propagate
                if verified:
                    # the footer proved the bytes are exactly what save
                    # wrote — this failure is environmental
                    raise
                raise CheckpointCorruptError(
                    f"{path}: cannot unpickle checkpoint payload ({e}) — "
                    "the file is truncated or corrupt") from e
            out = _unpack(payload, dev)
    except BaseException:
        sp.end(error=True)   # the failed load still leaves its span
        raise
    _record_ckpt("load", path, t0, span=sp)
    return out


def save_dygraph(state_dict, model_path):
    save(state_dict, model_path + (".pdparams"
                                   if not model_path.endswith(".pdparams")
                                   else ""))


def load_dygraph(model_path, device=None, **configs):
    params_path = model_path + ".pdparams"
    opt_path = model_path + ".pdopt"
    para = load(params_path, device=device, **configs) \
        if os.path.exists(params_path) else None
    opt = load(opt_path, device=device, **configs) \
        if os.path.exists(opt_path) else None
    return para, opt
