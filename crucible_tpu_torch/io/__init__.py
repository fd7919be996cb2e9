"""Host-side IO: HDR decode, asset search, the procedural garden sky and
PPM/PNG film output (port of ``crucible_tpu/io``)."""
