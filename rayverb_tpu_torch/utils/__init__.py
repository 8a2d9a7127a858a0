from .directions import morton_sort, random_directions, uniform_directions
