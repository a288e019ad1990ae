"""Meshes and collectives: the one-process device mesh of the ring
(`mesh.Mesh`), the mesh of ranks of multi-GPU serving (`mesh.RankMesh`,
`distributed`, `collectives`), the DiT's tensor-parallel cuts (`specs`) and
the serving dryruns (`dryrun`)."""
