from .grid import GridBatch, pack_grid
from .preprocess import LocalGraph, VoxelGraph, process_building
from .synthetic import generate_building, generate_building_real_scale
