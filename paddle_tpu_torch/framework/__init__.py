"""Framework utilities (ports paddle_tpu/framework/): weight-version
lineage (``lineage``). The reference's io, AOT compile cache and crypto
are not ported."""
from . import lineage
from .lineage import WeightVersion, new_run_id

__all__ = ["lineage", "WeightVersion", "new_run_id"]
