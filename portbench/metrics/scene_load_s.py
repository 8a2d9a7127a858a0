"""scene_load_s: seconds of the program's load_scene (the OBJ parse and the
scene compile), host clock around the call in set-up."""


def read(ctx):
    return ctx["spans"].get("scene_load_s")
