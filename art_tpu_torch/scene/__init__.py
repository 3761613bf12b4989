"""Scene DSL, compiler and flat tables (spheres, materials, textures)."""
