"""Framework utilities (ports paddle_tpu/framework/): weight-version
lineage (``lineage``) and save / load (``io``). The reference's AOT
compile cache and crypto are not ported."""
from . import io, lineage
from .io import CheckpointCorruptError, load, save
from .lineage import WeightVersion, new_run_id

__all__ = ["CheckpointCorruptError", "io", "lineage", "load", "save",
           "WeightVersion", "new_run_id"]
