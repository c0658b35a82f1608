"""Record sources (synthetic, segment files) and the native ingest shim."""
