"""The plain reference that decides ``correct``: scene input (scene.py),
the closest-hit query (geometry.py) and the render (render.py). It imports
nothing of the program."""
