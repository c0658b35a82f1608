"""Report table rendering and chrono-compatible time formatting."""
