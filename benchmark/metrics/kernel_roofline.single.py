"""kernel_roofline.single: kernel_roofline (metrics/kernel_roofline.py) in
the cells where a request is one search, where it moves search_gcups."""

from swbench.spec import reader

read = reader("kernel_roofline")
