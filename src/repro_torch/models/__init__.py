"""The LM side of the port: layers, attention, Maclaurin attention and the
decoder stack (``repro/models/`` for the dense and audio families)."""
