"""Host-side data: PDB parsing and writing, the preprocessing cache, batch
collation and synthetic complexes."""
