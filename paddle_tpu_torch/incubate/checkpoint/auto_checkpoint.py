"""Auto-checkpoint / resume.

Ports paddle_tpu/incubate/checkpoint/auto_checkpoint.py
(python/paddle/fluid/incubate/checkpoint/auto_checkpoint.py —
TrainEpochRange:265, and checkpoint_saver.py's CheckpointSaver):
``CheckpointSaver`` keeps numbered checkpoint directories
(``__paddle_checkpoint__.<n>``, each a ``state.pdparams`` written through
framework/io and a ``meta.json``), ``max_num`` of them, committed by an
atomic directory rename after the ``ckpt/commit`` failpoint; construction
sweeps tmp directories of crashed saves; ``load_checkpoint()`` walks back
past a corrupt newest checkpoint (evicting it, counting
``checkpoint_recover_total{reason=corrupt}``). ``TrainEpochRange`` /
``train_epoch_range`` resume an epoch loop from the last committed epoch.

Loads place tensors on the saver's ``device`` (``cuda`` unless the caller
passes another). A layer restores through ``set_state_dict`` when it has
one, else torch's ``load_state_dict``.
"""
import contextlib
import json
import os
import shutil
import time
import warnings

from ... import flags as _flags
from ... import monitor as _monitor
from ...core.device import resolve_device
from ...framework.io import CheckpointCorruptError, _fsync_dir
from ...framework.io import load as pload
from ...framework.io import save as psave
from ...testing import failpoints as _fp

_JOB_ID_ENV = "PADDLE_JOB_ID"
_CHECKPOINT_PATH_ENV = "PADDLE_CHECKPOINT_DIR"

# errors that mean THIS checkpoint's bytes are bad (evict + fall back);
# anything else — permissions, fd exhaustion, a missing encryption key —
# must propagate instead of destroying a checkpoint that may be fine
_CORRUPT_ERRORS = (CheckpointCorruptError, json.JSONDecodeError, EOFError,
                   FileNotFoundError, NotADirectoryError, UnicodeDecodeError)

# tmp dirs a save_checkpoint in THIS process is writing right now — a
# sibling CheckpointSaver constructed on another thread must not sweep them
_ACTIVE_TMPS = set()

def _goodput_bucket(name):
    """ckpt_save/ckpt_restore attribution for the SAVER's own overhead
    (FLAGS_goodput) — tmp-dir setup, meta.json, commit rename,
    rotation, and the corrupt-fallback walk-back. The inner psave/pload
    legs nest the SAME bucket via framework/io.py (harmless: one pauses
    while the other books, totals stay exclusive). Null context when the
    accountant is disarmed; the import stays manifest-lazy."""
    if not _flags.get_flag("goodput", False):
        return contextlib.nullcontext()
    from ...monitor import goodput as _goodput

    return _goodput.bucket(name)


_RECOVER = _monitor.counter(
    "checkpoint_recover_total",
    "checkpoint recovery actions by reason (corrupt = an unreadable newest "
    "checkpoint was evicted and an older one restored; tmp_swept = a stale "
    ".tmp dir from a crashed run was reclaimed)",
    labelnames=("reason",))


class CheckpointSaver:
    """checkpoint_saver.py parity: numbered checkpoints, keep max_num.

    Robustness: construction sweeps orphaned
    ``__paddle_checkpoint__.*.tmp`` dirs left by crashed runs, and
    ``load_checkpoint()`` (no explicit number) walks backward to the newest
    *valid* checkpoint, evicting corrupt ones instead of crashing on them —
    a process killed mid-save never bricks the resume path."""

    def __init__(self, directory, max_num=3, device=None):
        self.directory = directory
        self.max_num = max_num
        self.device = resolve_device(device)
        os.makedirs(directory, exist_ok=True)
        self.sweep_tmp()

    def _ckpt_dir(self, no):
        return os.path.join(self.directory, f"__paddle_checkpoint__.{no}")

    # a marker-less tmp dir younger than this may be a concurrent saver
    # between its makedirs and its owner.pid write — don't sweep it yet
    _TMP_GRACE_S = 60.0

    @staticmethod
    def _tmp_is_orphan(tmp_dir):
        """True when a tmp dir is a reclaimable crash leftover. A dir whose
        owner.pid marker names a live OTHER process is a concurrent saver
        mid-commit in a shared directory; our own pid is live only while a
        save_checkpoint is actually inside its commit window (_ACTIVE_TMPS
        — another thread of this process), otherwise it is an aborted
        attempt. A marker-less dir gets a short grace period to cover the
        makedirs→marker-write window."""
        if os.path.abspath(tmp_dir) in _ACTIVE_TMPS:
            return False   # a saver thread in THIS process is writing it
        try:
            with open(os.path.join(tmp_dir, "owner.pid")) as f:
                pid = int(f.read().strip())
        except (OSError, ValueError):
            try:
                age = time.time() - os.stat(tmp_dir).st_mtime
            except OSError:
                return False   # vanished under us — nothing to reclaim
            return age > CheckpointSaver._TMP_GRACE_S
        if pid == os.getpid():
            return True    # ours but not active — an aborted attempt
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        except OSError:
            pass           # e.g. EPERM: it exists but isn't ours
        return False

    def sweep_tmp(self):
        """Reclaim orphaned .tmp checkpoint dirs (crash-mid-save leftovers);
        returns how many were removed. Tmp dirs owned by a live concurrent
        saver (owner.pid marker, or young enough to still be writing one)
        are left alone."""
        removed = 0
        for name in os.listdir(self.directory):
            if name.startswith("__paddle_checkpoint__.") \
                    and name.endswith(".tmp"):
                path = os.path.join(self.directory, name)
                if not self._tmp_is_orphan(path):
                    continue
                shutil.rmtree(path, ignore_errors=True)
                removed += 1
        if removed and _monitor.is_enabled():
            _RECOVER.labels(reason="tmp_swept").inc(removed)
        return removed

    def get_checkpoint_numbers(self):
        nums = []
        for name in os.listdir(self.directory):
            if name.startswith("__paddle_checkpoint__.") and not name.endswith(".tmp"):
                try:
                    nums.append(int(name.rsplit(".", 1)[1]))
                except ValueError:
                    pass
        return sorted(nums)

    def save_checkpoint(self, state, meta=None):
        with _goodput_bucket("ckpt_save"):
            nums = self.get_checkpoint_numbers()
            no = (nums[-1] + 1) if nums else 0
            tmp = self._ckpt_dir(no) + ".tmp"
            _ACTIVE_TMPS.add(os.path.abspath(tmp))
            try:
                os.makedirs(tmp, exist_ok=True)
                with open(os.path.join(tmp, "owner.pid"), "w") as f:
                    f.write(str(os.getpid()))  # sweep_tmp skips live owners
                psave(state, os.path.join(tmp, "state.pdparams"))
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump({"no": no, "time": time.time(),
                               **(meta or {})}, f)
                _fp.failpoint("ckpt/commit")
                os.remove(os.path.join(tmp, "owner.pid"))
                os.rename(tmp, self._ckpt_dir(no))  # atomic commit
            finally:
                _ACTIVE_TMPS.discard(os.path.abspath(tmp))
            # make the commit durable BEFORE rotating older checkpoints
            # away: a crash here must find either the new dir or the old
            # ones on disk
            _fsync_dir(self.directory)
            for old in self.get_checkpoint_numbers()[: -self.max_num]:
                shutil.rmtree(self._ckpt_dir(old), ignore_errors=True)
            return no

    def _load_one(self, no):
        d = self._ckpt_dir(no)
        state = pload(os.path.join(d, "state.pdparams"), device=self.device)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return state, meta

    def load_checkpoint(self, no=None):
        """Newest valid checkpoint (or the explicit `no`, which raises on
        corruption instead of falling back). An unreadable newest
        checkpoint — truncated state file, missing meta, failed sha256
        footer — is EVICTED and the walk continues to the previous one,
        counting checkpoint_recover_total{reason=corrupt}."""
        with _goodput_bucket("ckpt_restore"):
            nums = self.get_checkpoint_numbers()
            if not nums:
                return None, None
            if no is not None:
                return self._load_one(no)
            for cand in reversed(nums):
                try:
                    return self._load_one(cand)
                except _CORRUPT_ERRORS as e:
                    d = self._ckpt_dir(cand)
                    warnings.warn(
                        f"checkpoint {d} is unreadable ({type(e).__name__}: "
                        f"{e}); evicting it and falling back to the "
                        "previous checkpoint")
                    shutil.rmtree(d, ignore_errors=True)
                    if _monitor.is_enabled():
                        _RECOVER.labels(reason="corrupt").inc()
            return None, None


class TrainEpochRange:
    """auto_checkpoint.py:265 parity: `for epoch in TrainEpochRange(n, name):` resumes
    from the last committed epoch after a restart."""

    def __init__(self, max_epoch_num, name, checkpoint_inter=None,
                 save_dir=None, device=None):
        self.max_epoch_num = max_epoch_num
        self.name = name
        job_id = os.environ.get(_JOB_ID_ENV, "default_job")
        root = save_dir or os.environ.get(_CHECKPOINT_PATH_ENV,
                                          "/tmp/paddle_tpu_auto_ckpt")
        self._saver = CheckpointSaver(os.path.join(root, job_id, name),
                                      device=device)
        self._layers = []
        self._optimizers = []
        state, meta = self._saver.load_checkpoint()
        self._restored_state = state
        self._start_epoch = (meta.get("epoch", -1) + 1) if meta else 0

    def add(self, layer=None, optimizer=None):
        """Register objects whose state rides the checkpoint."""
        if layer is not None:
            self._layers.append(layer)
        if optimizer is not None:
            self._optimizers.append(optimizer)
        if self._restored_state is not None:
            for i, l in enumerate(self._layers):
                key = f"layer{i}"
                if key in self._restored_state:
                    restore = getattr(l, "set_state_dict", None) \
                        or l.load_state_dict
                    restore(self._restored_state[key])
            for i, o in enumerate(self._optimizers):
                key = f"opt{i}"
                if key in self._restored_state:
                    o.set_state_dict(self._restored_state[key])
        return self

    def get(self):
        return range(self._start_epoch, self.max_epoch_num)

    def __iter__(self):
        for epoch in self.get():
            yield epoch
            self.save(epoch)

    def save(self, epoch):
        state = {}
        for i, l in enumerate(self._layers):
            state[f"layer{i}"] = l.state_dict()
        for i, o in enumerate(self._optimizers):
            state[f"opt{i}"] = o.state_dict()
        self._saver.save_checkpoint(state, meta={"epoch": epoch})


def train_epoch_range(max_epoch_num, name="train", save_dir=None,
                      device=None):
    return TrainEpochRange(max_epoch_num, name, save_dir=save_dir,
                           device=device)
