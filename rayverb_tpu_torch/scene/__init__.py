from .objloader import RawMesh, load_mesh, load_obj
from .materials import SurfaceSet, MaterialError, load_materials, parse_materials
from .compile import Scene, SceneError, compile_scene, load_scene
