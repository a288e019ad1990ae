"""Device meshes (`mesh.Mesh`, `mesh.make_mesh`)."""
