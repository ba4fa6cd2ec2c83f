"""Data: numpy registration pairs (synthetic, the indoor sequence's
adjacent scans, the h5 test files, the RPM-Net h5 pairs), the synthetic
indoor sequence, the ModelNet40 split, its 4-class reflection variant,
the ShapeNet part segmentation split (copies of the reference's); grid
subsampling (host C++, built at its first call) is
`data.grid_subsample.grid_subsample`, as in the reference."""
from .modelnet40 import ModelNet40, ModelNet40Config, get_datasets  # noqa: F401
from .shapenet import ShapeNet, ShapeNetConfig, get_shapenet  # noqa: F401
from .sequences import (SequenceConfig, SyntheticSequence, get_sequence,  # noqa: F401
                        make_room_scene, make_trajectory)
from .synthetic_pairs import (H5TestPairs, PairBatch, SequencePairs,  # noqa: F401
                              SyntheticPairs, get_pairs)
from .mn40_hdf import Mn40HdfConfig, ModelNetHdf  # noqa: F401
from .modelnet40_4class import ModelNet40FourClass, reflection_label  # noqa: F401
