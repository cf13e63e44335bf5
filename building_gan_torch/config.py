"""Configuration of the port: the same field names and defaults as the JAX
package's ``Configuration`` (which mirrors the reference ``config.py``).

Knobs that only schedule TPU work (``PACK_NARROW_GEMMS``, ``UNROLL_CRITIC``,
``REMAT_HOURGLASS``, ``PRNG_IMPL``, ``DEVICE_RESIDENT_DATA``, ...) are kept
as fields so a run configuration maps 1:1, and are read by nothing in the
port.  ``compute_dtype`` / ``param_dtype`` map the dtype names to torch
dtypes; ``require_ported_dtype`` refuses a COMPUTE_DTYPE that names none of
them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Tuple

import torch

# Program map (reference config.py:9-30)
VOID_OLD = -1  # legacy label remapped to VOID during preprocessing

LOBBY_CORRIDOR = 0
RESTROOM = 1
STAIRS = 2
ELEVATOR = 3
OFFICE = 4
MECHANICAL_ROOM = 5
VOID = 6

COLORS: Dict[int, str] = {
    LOBBY_CORRIDOR: "brown",
    RESTROOM: "red",
    STAIRS: "yellow",
    ELEVATOR: "green",
    OFFICE: "blue",
    MECHANICAL_ROOM: "orange",
    VOID: "gray",
}

PROGRAM_NAMES: Dict[int, str] = {
    LOBBY_CORRIDOR: "LOBBY_CORRIDOR",
    RESTROOM: "RESTROOM",
    STAIRS: "STAIRS",
    ELEVATOR: "ELEVATOR",
    OFFICE: "OFFICE",
    MECHANICAL_ROOM: "MECHANICAL_ROOM",
    VOID: "VOID",
}

NUM_CLASSES = len(COLORS)  # 7

# Compute dtypes the port takes, in the order of the CUDA kernels' storage codes
# (ops/hourglass.py::STORAGE_DTYPES).
PORTED_DTYPES = ("float32", "bfloat16", "float16")

_TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def _default_data_root() -> str:
    return os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "data"))


@dataclasses.dataclass
class Configuration:
    """All knobs for data, model, training and serving (flat dataclass)."""

    # --- ProgramMap ---
    NUM_CLASSES: int = NUM_CLASSES
    VOID: int = VOID
    VOID_OLD: int = VOID_OLD

    # --- DataConfiguration ---
    DATA_PATH: str = dataclasses.field(
        default_factory=lambda: os.path.join(_default_data_root(), "6types-raw_data")
    )
    SAVE_DATA_PATH: str = dataclasses.field(
        default_factory=lambda: os.path.join(_default_data_root(), "6types-processed_data")
    )
    NORMALIZATION_FACTOR_FLOOR_LEVEL: float = 10.0
    NORMALIZATION_FACTOR_DIMENSION: float = 11.0
    NORMALIZATION_FACTOR_LOCATION: float = 11.0
    NORMALIZATION_FACTOR_COORDINATE: float = 42.0
    NORMALIZATION_FACTOR_SITE: float = 1600.0
    LOCAL_DATA_SUFFIX: str = "_local.npz"
    VOXEL_DATA_SUFFIX: str = "_voxel.npz"

    # --- ModelConfiguration ---
    EPOCHS: int = 5000
    SEED: int = 777

    TRAIN_SPLIT_RATIO: float = 0.65
    VALIDATION_SPLIT_RATIO: float = 0.25
    TEST_SPLIT_RATIO: float = 0.10

    DATA_POINT: int | None = None
    DATA_SLICER: int = int(1e10)
    BATCH_SIZE: int = 512

    N_CRITIC: int = 5
    LEARNING_RATE_GENERATOR: float = 2e-4
    LEARNING_RATE_DISCRIMINATOR: float = 2e-4

    LAMBDA_RATIO: float = 0.1
    LAMBDA_RATIO_VOID: float = 0.1
    LAMBDA_LABEL: float = 0.0
    LAMBDA_ADV: float = 1.0
    LAMBDA_FAR: float = 0.1
    LAMBDA_GP: float = 10.0

    BETAS: Tuple[float, float] = (0.5, 0.999)

    F1_SCORE_TRAIN_WEIGHT: float = 0.05
    F1_SCORE_VALIDATION_WEIGHT: float = 1.0

    METRICS_AVERAGE: str = "macro"

    LOG_DIR: str = dataclasses.field(
        default_factory=lambda: os.path.abspath(
            os.path.join(os.path.dirname(__file__), "..", "runs")
        )
    )

    GENERATOR_CONV_TYPE: str = "GATCONV"
    GENERATOR_ENCODER_REPEAT: int = 7
    GENERATOR_HIDDEN_DIM: int = 128
    GENERATOR_ARCH: str = "hourglass"
    TRANSFORMER_LAYERS: int = 4
    TRANSFORMER_HEADS: int = 4

    DISCRIMINATOR_CONV_TYPE: str = "GATCONV"
    DISCRIMINATOR_ENCODER_REPEAT: int = 3
    DISCRIMINATOR_HIDDEN_DIM: int = 64

    Z_DIM: int = 128
    LOCAL_GRAPH_ENCODER_REPEAT: int = 4
    LOCAL_ENCODER_HIDDEN_DIM: int = 128
    ENCODER_DROPOUT_RATE: float = 0.2

    GENERATOR_MLP_ENCODER_REPEAT: int = 4

    USE_WGANGP: bool = True

    SANITY_CHECKING: bool = False
    sanity_checking: dataclasses.InitVar[bool] = False

    # --- packing budgets and layout ---
    PACK_GRAPHS: int = 64
    PACK_LOCAL_NODES: int = 2048
    PACK_LOCAL_EDGES: int = 8192
    PACK_VOXEL_NODES: int = 32768
    PACK_VOXEL_EDGES: int = 262144

    # Dense grid: (floors, y cells, x cells) covers every reference building.
    GRID_SHAPE: Tuple[int, int, int] = (11, 12, 12)
    GRID_BATCH: int = 64
    GRID_LOCAL_NODES: int = 64
    GRID_SLOT_GRAPHS: int = 1
    GRID_PACK_MODE: str = "cell"
    GRID_BUCKETS: Tuple[Tuple[int, int, int], ...] | None = None
    LAYOUT: str = "grid"
    DEVICE_RESIDENT_DATA: bool = False
    DEVICE_RESIDENT_COMPOSITIONS: int = 1
    CKPT_LATEST_INTERVAL: int = 0

    # dtype policy
    COMPUTE_DTYPE: str = "bfloat16"
    PARAM_DTYPE: str = "float32"

    PRNG_IMPL: str = "auto"
    MESH_DATA: int = 1

    # Quirk parity flags (whole-batch pooling / norm statistics).
    BATCH_LEVEL_MATCHING: bool = False
    BATCH_LEVEL_GRAPHNORM: bool = False
    USE_PALLAS: bool = False
    USE_PALLAS_TRAIN: bool = False
    PALLAS_TRAIN_TILE: int = 1
    UNROLL_CRITIC: bool = False
    REMAT_HOURGLASS: bool = False
    PACK_NARROW_GEMMS: bool = False
    HOURGLASS_MIN_CHANNELS: int = 1
    GP_DTYPE: str = "compute"

    def __post_init__(self, sanity_checking: bool = False):
        if sanity_checking:
            self.SANITY_CHECKING = True
        if self.SANITY_CHECKING:
            # reference sanity mode: a single datum at batch size 1
            self.BATCH_SIZE = 1
            if self.DATA_POINT is None:
                self.DATA_POINT = 77
            self.PACK_GRAPHS = 1
            self.GRID_BATCH = 1

    @property
    def compute_dtype(self) -> torch.dtype:
        """Activation/matmul dtype (COMPUTE_DTYPE) as a torch dtype."""
        return _TORCH_DTYPES[self.COMPUTE_DTYPE]

    @property
    def param_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.PARAM_DTYPE]

    @property
    def SPLIT_RATIOS(self) -> Tuple[float, float, float]:
        return (self.TRAIN_SPLIT_RATIO, self.VALIDATION_SPLIT_RATIO, self.TEST_SPLIT_RATIO)

    @property
    def GLOBAL_GRAPH_DATA_PATH(self) -> str:
        return os.path.join(self.DATA_PATH, "global_graph_data")

    @property
    def LOCAL_GRAPH_DATA_PATH(self) -> str:
        return os.path.join(self.DATA_PATH, "local_graph_data")

    @property
    def VOXEL_GRAPH_DATA_PATH(self) -> str:
        return os.path.join(self.DATA_PATH, "voxel_data")

    def require_ported_dtype(self, where: str) -> None:
        """Raise unless COMPUTE_DTYPE names a dtype the port computes in (``PORTED_DTYPES``)."""
        if self.COMPUTE_DTYPE not in PORTED_DTYPES:
            raise ValueError(
                f"{where}: COMPUTE_DTYPE={self.COMPUTE_DTYPE!r} is not ported; the port computes "
                f"in {', '.join(PORTED_DTYPES)}"
            )

    def to_dict(self) -> Dict[str, object]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def replace(self, **kwargs) -> "Configuration":
        return dataclasses.replace(self, **kwargs)

    @staticmethod
    def set_seed(seed: int | None = None) -> None:
        """Seed the host RNGs and torch's default generator (reference
        ``config.py:137-157``; ``utils/profiling.py::set_seed``), 777 by default."""
        from .utils.profiling import set_seed as _set_seed

        _set_seed(777 if seed is None else seed)
