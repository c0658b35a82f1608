"""The torch backend, its step and its finalize."""
