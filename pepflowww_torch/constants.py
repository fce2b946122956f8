"""Chemical constants and static tables for the PyTorch package.

The 21-way amino-acid vocabulary (+UNK, +PAD), the 15-slot heavy-atom layout,
chi-angle definitions and the AF2-style rigid-group tables. The numeric tables
live in ``ops/_tables.npz`` (the package's own copy); they are chemical facts,
snapshotted once from the reference PepFlow table builders.

Only what the sampler, the training objective, the full-atom rebuild and
the PDB parser and writer read is kept here. All tables are numpy arrays;
ops move them to the device they need.
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

    @classmethod
    def _missing_(cls, value):
        """Three-letter names (modified residues mapped onto their canonical
        parents) and one-letter symbols."""
        if isinstance(value, str) and len(value) == 3:
            name = NON_STANDARD_RESIDUE_SUBSTITUTIONS.get(value, value)
            if name in cls.__members__:
                return cls.__members__[name]
        elif isinstance(value, str) and len(value) == 1:
            if value in RESSYMB_TO_RESINDEX:
                return cls(RESSYMB_TO_RESINDEX[value])
        return super()._missing_(value)

    @classmethod
    def is_aa(cls, value) -> bool:
        return (value in RESSYMB_TO_RESINDEX or value in NON_STANDARD_RESIDUE_SUBSTITUTIONS
                or value in cls.__members__)


class BBHeavyAtom(enum.IntEnum):
    """Backbone heavy-atom slots in the 15-atom layout."""

    N = 0; CA = 1; C = 2; O = 3; CB = 4; OXT = 14


RESSYMB_TO_RESINDEX = {
    'A': 0, 'C': 1, 'D': 2, 'E': 3, 'F': 4,
    'G': 5, 'H': 6, 'I': 7, 'K': 8, 'L': 9,
    'M': 10, 'N': 11, 'P': 12, 'Q': 13, 'R': 14,
    'S': 15, 'T': 16, 'V': 17, 'W': 18, 'Y': 19,
    'X': 20,
}
RESINDEX_TO_RESSYMB = {v: k for k, v in RESSYMB_TO_RESINDEX.items()}

# PDB chemical-component remapping of modified residues onto their canonical
# parents (the standard table), for the PDB parser.
NON_STANDARD_RESIDUE_SUBSTITUTIONS = {
    '2AS': 'ASP', '3AH': 'HIS', '5HP': 'GLU', 'ACL': 'ARG', 'AGM': 'ARG',
    'AIB': 'ALA', 'ALM': 'ALA', 'ALO': 'THR', 'ALY': 'LYS', 'ARM': 'ARG',
    'ASA': 'ASP', 'ASB': 'ASP', 'ASK': 'ASP', 'ASL': 'ASP', 'ASQ': 'ASP',
    'AYA': 'ALA', 'BCS': 'CYS', 'BHD': 'ASP', 'BMT': 'THR', 'BNN': 'ALA',
    'BUC': 'CYS', 'BUG': 'LEU', 'C5C': 'CYS', 'C6C': 'CYS', 'CAS': 'CYS',
    'CCS': 'CYS', 'CEA': 'CYS', 'CGU': 'GLU', 'CHG': 'ALA', 'CLE': 'LEU',
    'CME': 'CYS', 'CSD': 'ALA', 'CSO': 'CYS', 'CSP': 'CYS', 'CSS': 'CYS',
    'CSW': 'CYS', 'CSX': 'CYS', 'CXM': 'MET', 'CY1': 'CYS', 'CY3': 'CYS',
    'CYG': 'CYS', 'CYM': 'CYS', 'CYQ': 'CYS', 'DAH': 'PHE', 'DAL': 'ALA',
    'DAR': 'ARG', 'DAS': 'ASP', 'DCY': 'CYS', 'DGL': 'GLU', 'DGN': 'GLN',
    'DHA': 'ALA', 'DHI': 'HIS', 'DIL': 'ILE', 'DIV': 'VAL', 'DLE': 'LEU',
    'DLY': 'LYS', 'DNP': 'ALA', 'DPN': 'PHE', 'DPR': 'PRO', 'DSN': 'SER',
    'DSP': 'ASP', 'DTH': 'THR', 'DTR': 'TRP', 'DTY': 'TYR', 'DVA': 'VAL',
    'EFC': 'CYS', 'FLA': 'ALA', 'FME': 'MET', 'GGL': 'GLU', 'GL3': 'GLY',
    'GLZ': 'GLY', 'GMA': 'GLU', 'GSC': 'GLY', 'HAC': 'ALA', 'HAR': 'ARG',
    'HIC': 'HIS', 'HIP': 'HIS', 'HMR': 'ARG', 'HPQ': 'PHE', 'HTR': 'TRP',
    'HYP': 'PRO', 'IAS': 'ASP', 'IIL': 'ILE', 'IYR': 'TYR', 'KCX': 'LYS',
    'LLP': 'LYS', 'LLY': 'LYS', 'LTR': 'TRP', 'LYM': 'LYS', 'LYZ': 'LYS',
    'MAA': 'ALA', 'MEN': 'ASN', 'MHS': 'HIS', 'MIS': 'SER', 'MLE': 'LEU',
    'MPQ': 'GLY', 'MSA': 'GLY', 'MSE': 'MET', 'MVA': 'VAL', 'NEM': 'HIS',
    'NEP': 'HIS', 'NLE': 'LEU', 'NLN': 'LEU', 'NLP': 'LEU', 'NMC': 'GLY',
    'OAS': 'SER', 'OCS': 'CYS', 'OMT': 'MET', 'PAQ': 'TYR', 'PCA': 'GLU',
    'PEC': 'CYS', 'PHI': 'PHE', 'PHL': 'PHE', 'PR3': 'CYS', 'PRR': 'ALA',
    'PTR': 'TYR', 'PYX': 'CYS', 'SAC': 'SER', 'SAR': 'GLY', 'SCH': 'CYS',
    'SCS': 'CYS', 'SCY': 'CYS', 'SEL': 'SER', 'SEP': 'SER', 'SET': 'SER',
    'SHC': 'CYS', 'SHR': 'LYS', 'SMC': 'CYS', 'SOC': 'CYS', 'STY': 'TYR',
    'SVA': 'SER', 'TIH': 'ALA', 'TPL': 'TRP', 'TPO': 'THR', 'TPQ': 'ALA',
    'TRG': 'LYS', 'TRO': 'TRP', 'TYB': 'TYR', 'TYI': 'TYR', 'TYQ': 'TYR',
    'TYS': 'TYR', 'TYY': 'TYR',
    'ALA': 'ALA', 'CYS': 'CYS', 'ASP': 'ASP', 'GLU': 'GLU', 'PHE': 'PHE',
    'GLY': 'GLY', 'HIS': 'HIS', 'ILE': 'ILE', 'LYS': 'LYS', 'LEU': 'LEU',
    'MET': 'MET', 'ASN': 'ASN', 'PRO': 'PRO', 'GLN': 'GLN', 'ARG': 'ARG',
    'SER': 'SER', 'THR': 'THR', 'VAL': 'VAL', 'TRP': 'TRP', 'TYR': 'TYR',
    'UNK': 'UNK',
}

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
