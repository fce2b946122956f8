"""Chemical constants and static tables for the PyTorch package.

The 21-way amino-acid vocabulary (+UNK, +PAD), the 15-slot heavy-atom layout,
chi-angle definitions and the AF2-style rigid-group tables. The numeric tables
live in ``ops/_tables.npz`` (the package's own copy); they are chemical facts,
snapshotted once from the reference PepFlow table builders.

Only what the sampler, the training objective, the full-atom rebuild and
the PDB writer read is kept here. All tables are numpy arrays; ops move them
to the device they need.
"""

from __future__ import annotations

import enum
import os

import numpy as np

NM_TO_ANG_SCALE = 10.0
ANG_TO_NM_SCALE = 1.0 / NM_TO_ANG_SCALE

PAD_RESIDUE_INDEX = 21
MAX_NUM_HEAVYATOMS = 15
NUM_AA_TYPES = 21          # 20 canonical + UNK
NUM_AA_CLASSES = 20        # flow-matched sequence classes
MAX_AA_TYPES = 22          # embedding vocabulary: 20 + UNK + PAD

# Frame indices into the 8-slot rigid-group axis.
BACKBONE_FRAME = 0
OMEGA_FRAME = 1
PHI_FRAME = 2
PSI_FRAME = 3
CHI1_FRAME, CHI2_FRAME, CHI3_FRAME, CHI4_FRAME = 4, 5, 6, 7


class AA(enum.IntEnum):
    """Amino-acid vocabulary, index-compatible with the reference AA enum."""

    ALA = 0; CYS = 1; ASP = 2; GLU = 3; PHE = 4
    GLY = 5; HIS = 6; ILE = 7; LYS = 8; LEU = 9
    MET = 10; ASN = 11; PRO = 12; GLN = 13; ARG = 14
    SER = 15; THR = 16; VAL = 17; TRP = 18; TYR = 19
    UNK = 20


class BBHeavyAtom(enum.IntEnum):
    """Backbone heavy-atom slots in the 15-atom layout."""

    N = 0; CA = 1; C = 2; O = 3; CB = 4; OXT = 14


_TABLES_PATH = os.path.join(os.path.dirname(__file__), "ops", "_tables.npz")
_T = np.load(_TABLES_PATH, allow_pickle=False)

#: (22, 15) bool — atom slots used when generating structures (excludes OXT)
HEAVYATOM_MASK_GEN: np.ndarray = _T["heavyatom_mask_gen"]
#: per-restype heavy atom names; list of 22 lists of 15 strings
HEAVYATOM_NAMES = [s.split(",") for s in _T["heavyatom_names"].tolist()]
#: (21, 4) float32 — which chi angles exist per restype
CHI_ANGLES_MASK: np.ndarray = _T["chi_angles_mask"]
#: (22, 5) float32 — [psi, chi1..4] validity per restype (UNK/PAD rows zero)
TORSIONS_MASK: np.ndarray = _T["torsions_mask"]
#: (21, 4, 4) int32 — heavy-atom slots of the 4 atoms defining each chi (-1: none)
CHI_ATOM_INDICES: np.ndarray = _T["chi_atom_indices"]
#: (21, 8, 3, 3) / (21, 8, 3) — rigid-group frame of each torsion frame
#: relative to its parent (AF2 Alg. 24 tables)
RIGID_GROUP_ROTATION: np.ndarray = _T["rigid_group_rotation"]
RIGID_GROUP_TRANSLATION: np.ndarray = _T["rigid_group_translation"]
#: (21, 14) — owning rigid group of each atom14 slot
HEAVYATOM_TO_RIGID_GROUP: np.ndarray = _T["heavyatom_to_rigid_group"].astype(np.int64)
#: (21, 14, 3) — idealized atom coordinates within their rigid group
HEAVYATOM_RIGID_GROUP_POSITIONS: np.ndarray = _T["heavyatom_rigid_group_positions"]

#: (3, 3) float32 — N, CA, C of the idealized ALA backbone in its backbone
#: frame (AF2 atom14 rigid-group positions, group 0), for the backbone-atom
#: loss
BB3_IDEAL_COORDS: np.ndarray = np.array(
    [[-0.525, 1.363, 0.0], [0.0, 0.0, 0.0], [1.526, 0.0, 0.0]], dtype=np.float32)
