"""DSSP output parsing and secondary-structure ranges (the port's own copy
of the JAX package's ``data/dssp.py``): a parser of classic ``mkdssp``
output without Biopython, and range helpers over a chain's entries.

The 8-state alphabet: H G I (helix), E B (strand), T S - (other); the
index of a symbol is 0 for coil or other, 1 for helix, 2 for strand, as in
the reference.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HELIX = set("HGI")
STRAND = set("EB")


def secondary_struct_symbol_to_index(s: str) -> int:
    if s in HELIX:
        return 1
    if s in STRAND:
        return 2
    return 0


def make_dssp_dict(handle) -> Dict[str, list]:
    """Parse an mkdssp stream into {chain_id: [(resseq, icode, aa, ss), ...]};
    chain breaks ("!") and lines before the residue table are skipped, a
    blank structure column reads as "-"."""
    chains: Dict[str, list] = {}
    started = False
    for line in handle:
        if line.startswith("  #  RESIDUE"):
            started = True
            continue
        if not started or len(line) < 17 or line[13] == "!":
            continue
        try:
            resseq = int(line[5:10])
        except ValueError:
            continue
        ss = line[16] if line[16] != " " else "-"
        chains.setdefault(line[11], []).append((resseq, line[10], line[13], ss))
    return chains


def parse_dssp_file(path: str) -> Dict[str, list]:
    with open(path) as f:
        return make_dssp_dict(f)


def chain_ss_string(chain_entries: list) -> str:
    return "".join(e[3] for e in chain_entries)


def _runs(chain_entries: list) -> List[Tuple[int, int, int]]:
    """Maximal runs of one structure index as (start, end_exclusive, index)."""
    idxs = [secondary_struct_symbol_to_index(e[3]) for e in chain_entries]
    out, i = [], 0
    while i < len(idxs):
        j = i
        while j < len(idxs) and idxs[j] == idxs[i]:
            j += 1
        out.append((i, j, idxs[i]))
        i = j
    return out


def find_sstruct_ranges(chain_entries: list, min_length: int = 5) -> List[Tuple[int, int, int]]:
    """Contiguous helix or strand segments of at least `min_length` as
    (start, end_exclusive, ss_index)."""
    return [(i, j, k) for i, j, k in _runs(chain_entries) if k != 0 and j - i >= min_length]


def find_loop_fragments(chain_entries: list, min_length: int = 3,
                        max_length: float = float("inf")) -> List[Tuple[int, int]]:
    """Contiguous coil segments with a length in [min_length, max_length]."""
    return [(i, j) for i, j, k in _runs(chain_entries)
            if k == 0 and min_length <= j - i <= max_length]
