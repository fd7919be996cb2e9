"""Host-side IO: PPM/PNG film output (port of ``crucible_tpu/io``)."""
