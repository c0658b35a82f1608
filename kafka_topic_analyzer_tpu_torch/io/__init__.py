"""Record sources (synthetic)."""
