"""mistra_tpu: a JAX rebuild of the MISTRA 1-D marine-boundary-layer model.

A from-scratch JAX/XLA rebuild of the capabilities of the reference MISTRA
Fortran model (meteorology + 2-D spectral bin microphysics + PIFM2
radiation + photolysis + KPP-style multiphase chemistry), designed for
batched column ensembles on one GPU or sharded over several.
"""

from .config import GridParams, MistraConfig, config_from_namelist
from .grids import make_grids
from .model import Model
from .state import ModelState

__version__ = "0.1.0"
__all__ = [
    "GridParams", "MistraConfig", "config_from_namelist", "make_grids",
    "Model", "ModelState",
]
