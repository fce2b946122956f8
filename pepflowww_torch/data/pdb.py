"""PDB file IO without Biopython (counterpart of the JAX package's
``data/pdb.py``).

:func:`parse_pdb` keeps the reference parser's semantics:

* the first model only, the primary conformer (altloc " " or "A");
* chains sorted by chain id, residues by (resseq, icode);
* modified residues mapped onto their canonical parents, other HETATM
  groups skipped;
* residues lacking any of N/CA/C skipped; UNK residues counted, then
  skipped; ``(None, None)`` for a structure with no residue left or with
  a share of UNK residues at or above ``unknown_threshold``;
* heavy atoms scattered into the per-restype 15-slot layout;
* ``res_nb`` counts along each chain and jumps by at least 2 where
  consecutive CAs lie more than 4 Å apart.

:func:`save_pdb` writes one chain per unique chain_nb, atoms in the
per-restype 15-slot layout, masked atoms omitted.
"""

from __future__ import annotations

import numpy as np

from pepflowww_torch import constants as C


def _parse_atom_line(line: str):
    name = line[12:16].strip()
    altloc = line[16]
    resname = line[17:20].strip()
    chain_id = line[21]
    resseq = int(line[22:26])
    icode = line[26]
    xyz = (float(line[30:38]), float(line[38:46]), float(line[46:54]))
    return name, altloc, resname, chain_id, resseq, icode, xyz


def parse_pdb_atoms(path_or_str: str) -> dict:
    """ATOM/HETATM records of the first model, grouped:
    {chain_id: {(resseq, icode): {"resname": str, "atoms": {name: xyz}}}}.
    Takes a path, or the PDB text itself (any string holding a newline)."""
    if "\n" in path_or_str:
        lines = path_or_str.splitlines()
    else:
        with open(path_or_str) as f:
            lines = f.read().splitlines()
    chains: dict = {}
    for line in lines:
        rec = line[:6]
        if rec == "ENDMDL":
            break
        if rec not in ("ATOM  ", "HETATM") or len(line) < 54:
            continue
        try:
            name, altloc, resname, chain_id, resseq, icode, xyz = _parse_atom_line(line)
        except ValueError:
            continue
        if altloc not in (" ", "A"):
            continue
        res = chains.setdefault(chain_id, {}).setdefault(
            (resseq, icode), {"resname": resname, "atoms": {}})
        res["atoms"].setdefault(name, np.asarray(xyz, dtype=np.float32))
    return chains


def parse_pdb(path: str, unknown_threshold: float = 1.0):
    """A PDB file (or its text) as (item dict in the preprocessed schema,
    {(chain_id, resseq, icode): row}), or (None, None)."""
    chains = parse_pdb_atoms(path)
    data = {"chain_id": [], "chain_nb": [], "resseq": [], "icode": [], "res_nb": [],
            "aa": [], "pos_heavyatom": [], "mask_heavyatom": []}
    count_aa, count_unk = 0, 0
    for i, chain_id in enumerate(sorted(chains)):
        seq_this = 0
        for (resseq, icode), res in sorted(chains[chain_id].items(), key=lambda kv: kv[0]):
            if not C.AA.is_aa(res["resname"]):
                continue
            atoms = res["atoms"]
            if not ("CA" in atoms and "C" in atoms and "N" in atoms):
                continue
            restype = C.AA(res["resname"])
            count_aa += 1
            if restype == C.AA.UNK:
                count_unk += 1
                continue
            pos15 = np.zeros((C.MAX_NUM_HEAVYATOMS, 3), dtype=np.float32)
            mask15 = np.zeros((C.MAX_NUM_HEAVYATOMS,), dtype=bool)
            for idx, atom_name in enumerate(C.HEAVYATOM_NAMES[int(restype)]):
                if atom_name and atom_name in atoms:
                    pos15[idx] = atoms[atom_name]
                    mask15[idx] = True
            data["chain_id"].append(chain_id)
            data["chain_nb"].append(i)
            data["aa"].append(int(restype))
            data["pos_heavyatom"].append(pos15)
            data["mask_heavyatom"].append(mask15)
            if seq_this == 0:
                seq_this = 1
            else:
                ca = C.BBHeavyAtom.CA
                d_ca_ca = float(np.linalg.norm(data["pos_heavyatom"][-2][ca]
                                               - data["pos_heavyatom"][-1][ca]))
                seq_this += 1 if d_ca_ca <= 4.0 else max(2, resseq - data["resseq"][-1])
            data["resseq"].append(resseq)
            data["icode"].append(icode)
            data["res_nb"].append(seq_this)

    if not data["aa"]:
        return None, None
    if count_aa > 0 and count_unk / count_aa >= unknown_threshold:
        return None, None
    seq_map = {key: idx for idx, key in
               enumerate(zip(data["chain_id"], data["resseq"], data["icode"]))}
    out = {
        "chain_id": data["chain_id"],
        "icode": data["icode"],
        "chain_nb": np.asarray(data["chain_nb"], dtype=np.int64),
        "resseq": np.asarray(data["resseq"], dtype=np.int64),
        "res_nb": np.asarray(data["res_nb"], dtype=np.int64),
        "aa": np.asarray(data["aa"], dtype=np.int64),
        "pos_heavyatom": np.stack(data["pos_heavyatom"]),
        "mask_heavyatom": np.stack(data["mask_heavyatom"]),
    }
    return out, seq_map


def get_fasta_from_pdb(path: str) -> dict:
    """One-letter sequence of each chain: {chain_id: str}."""
    data, _ = parse_pdb(path)
    if data is None:
        return {}
    out: dict = {}
    for cid, aa in zip(data["chain_id"], data["aa"]):
        out[cid] = out.get(cid, "") + C.RESINDEX_TO_RESSYMB.get(int(aa), "X")
    return out


def renumber_pdb(data: dict, start: int = 1) -> dict:
    """`data` with resseq renumbered start, start+1, ... within each chain."""
    out = dict(data)
    resseq = np.asarray(data["resseq"]).copy()
    chain_nb = np.asarray(data["chain_nb"])
    for ch in np.unique(chain_nb):
        idx = np.nonzero(chain_nb == ch)[0]
        resseq[idx] = np.arange(start, start + len(idx))
    out["resseq"] = resseq
    return out


def strip_to_backbone(data: dict) -> dict:
    """`data` with every atom but N, CA, C and O masked out."""
    out = dict(data)
    mask = np.asarray(data["mask_heavyatom"]).copy()
    mask[:, 4:] = False
    out["mask_heavyatom"] = mask
    return out


_ELEMENT_OF = {"N": "N", "C": "C", "O": "O", "S": "S"}


def _atom_element(name: str) -> str:
    return _ELEMENT_OF.get(name[0], name[0])


def save_pdb(data: dict, path: str | None = None) -> str:
    """Write a structure dict to PDB format; returns the PDB text.

    Expects numpy fields aa/pos_heavyatom/mask_heavyatom/chain_nb/resseq and
    list fields chain_id/icode (the schema :func:`parse_pdb` emits).
    """
    aa = np.asarray(data["aa"])
    pos = np.asarray(data["pos_heavyatom"])
    mask = np.asarray(data["mask_heavyatom"])
    chain_nb = np.asarray(data["chain_nb"])
    resseq = np.asarray(data["resseq"])
    chain_ids = data.get("chain_id", ["A"] * len(aa))
    icodes = data.get("icode", [" "] * len(aa))

    lines = []
    serial = 1
    for ch in np.unique(chain_nb):
        idxs = np.nonzero(chain_nb == ch)[0]
        chain_letter = str(chain_ids[idxs[0]])[:1] or "A"
        for ri in idxs:
            restype = int(aa[ri])
            if restype >= C.NUM_AA_TYPES:
                continue
            resname = C.AA(restype).name
            for ai, atom_name in enumerate(C.HEAVYATOM_NAMES[restype]):
                if atom_name == "" or not mask[ri, ai]:
                    continue
                fullname = f" {atom_name:<3s}" if len(atom_name) < 4 else atom_name
                x, y, z = pos[ri, ai]
                ic = str(icodes[ri])[:1] or " "
                lines.append(
                    f"ATOM  {serial:5d} {fullname}{'':1s}{resname:>3s} {chain_letter}"
                    f"{int(resseq[ri]):4d}{ic}   {x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}"
                    f"          {_atom_element(atom_name):>2s}")
                serial += 1
        lines.append("TER")
    lines.append("END")
    text = "\n".join(lines) + "\n"
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text
