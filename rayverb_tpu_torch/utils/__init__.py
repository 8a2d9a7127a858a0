from .directions import (
    morton_order,
    morton_sort,
    random_directions,
    sphere_point,
    uniform_directions,
)
