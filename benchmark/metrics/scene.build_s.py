"""scene.build_s: host-clock seconds of the set-up's ``Scene.build`` of
the cell's scene on the device (``models/scene.py``), synchronized: the
one build a run makes (``Run.build``)."""


def read(run):
    return run.facts.get("scene_build_s")
