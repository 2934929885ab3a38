"""Weight-version lineage: a monotone identity for every weight state.

Ports paddle_tpu/framework/lineage.py: ``ORIGINS``, ``WeightVersion`` and
``new_run_id``. A served weight state carries a ``WeightVersion`` stamp,
``(run_id, counter, origin)``: the serving engine mints one for the params
it is built with, bumps it on ``hot_swap`` (origin ``hot_swap``), stamps
each adapter with the version it was loaded under (``adapter_load``), and
stamps every accepted request with the version it decodes under (its
``stats()["weight_version"]``). The stamp is host metadata only: it never
touches the device. The reference's trainer, checkpoint and monitor
consumers of the stamp are not ported.
"""
import itertools
import os
import time

__all__ = ["ORIGINS", "WeightVersion", "new_run_id"]

#: where a version bump came from. ``init`` — trainer/engine
#: construction; ``step`` — one optimizer step; ``restore`` — a
#: same-topology checkpoint restore; ``reshard`` — a cross-topology
#: restore or a live resize(mesh); ``hot_swap`` — a serving engine
#: replaced its resident base weights in place; ``adapter_load`` — a
#: LoRA adapter landed in a serving slot.
ORIGINS = ("init", "step", "restore", "reshard", "hot_swap",
           "adapter_load")

_RUN_SEQ = itertools.count()


def new_run_id():
    """Mint a process-unique run id: pid + monotonic-ish time + a
    process-local sequence number — unique enough to join ledger rows,
    spans, and checkpoints of one run without any coordination."""
    return f"r{os.getpid():x}-{time.time_ns():x}-{next(_RUN_SEQ)}"


class WeightVersion:
    """One immutable weight-state identity. ``counter`` is monotone
    within a lineage: every mutation of the weights (step, restore,
    reshard, hot-swap) yields a strictly larger counter via
    :meth:`bump`, so "older than" is one integer compare."""

    __slots__ = ("run_id", "counter", "origin")

    def __init__(self, run_id, counter=0, origin="init"):
        if origin not in ORIGINS:
            raise ValueError(
                f"unknown weight-version origin {origin!r} — one of "
                f"{ORIGINS}")
        counter = int(counter)
        if counter < 0:
            raise ValueError(f"counter must be >= 0, got {counter}")
        self.run_id = str(run_id)
        self.counter = counter
        self.origin = origin

    def bump(self, origin):
        """The next version in this lineage (counter + 1) with the given
        origin; the receiver is unchanged (versions are immutable)."""
        return WeightVersion(self.run_id, self.counter + 1, origin)

    def to_dict(self):
        """The ``__weight_version__`` checkpoint-leaf form (plain data,
        pickles through framework/io.py unchanged)."""
        return {"run_id": self.run_id, "counter": self.counter,
                "origin": self.origin}

    @classmethod
    def from_dict(cls, d, run_id=None):
        """Inverse of :meth:`to_dict`. ``None`` / a malformed dict — a
        pre-version checkpoint — loads as version 0 (origin ``init``)
        under ``run_id``: the handoff-baseline contract that old
        checkpoints stay loadable."""
        if not isinstance(d, dict):
            return cls(run_id if run_id is not None else new_run_id(),
                       0, "init")
        try:
            return cls(d.get("run_id", run_id or new_run_id()),
                       d.get("counter", 0),
                       d.get("origin", "init"))
        except (TypeError, ValueError):
            return cls(run_id if run_id is not None else new_run_id(),
                       0, "init")

    def __str__(self):
        return f"{self.run_id}:{self.counter}:{self.origin}"

    def __repr__(self):
        return (f"WeightVersion(run_id={self.run_id!r}, "
                f"counter={self.counter}, origin={self.origin!r})")

    def __eq__(self, other):
        return (isinstance(other, WeightVersion)
                and self.run_id == other.run_id
                and self.counter == other.counter
                and self.origin == other.origin)

    def __hash__(self):
        return hash((self.run_id, self.counter, self.origin))
