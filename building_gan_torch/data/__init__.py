from .grid import GridBatch, pack_grid, pack_grid_multi, pack_grid_multi_from_slots, plan_packing_slots
from .preprocess import LocalGraph, VoxelGraph, process_building
from .synthetic import generate_building, generate_building_real_scale, write_dataset
