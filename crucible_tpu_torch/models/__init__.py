"""Scene model: materials, textures, skybox, camera, integrator, scene API,
render drivers and the demo scenes (port of ``crucible_tpu/models``)."""
