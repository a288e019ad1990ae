"""Meshes and collectives: the one-process device mesh of the ring
(`mesh.Mesh`), the mesh of ranks of multi-GPU serving and training
(`mesh.RankMesh`, `distributed`, `collectives`), the DiT's tensor-parallel
cuts and FSDP (`specs`) and the dryruns (`dryrun`)."""
