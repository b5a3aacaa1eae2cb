"""Host-side utilities: FASTA reading, the ``.msh`` codec, stage tracing."""
