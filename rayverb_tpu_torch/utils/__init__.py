from .directions import (
    morton_order,
    morton_sort,
    random_directions,
    uniform_directions,
)
