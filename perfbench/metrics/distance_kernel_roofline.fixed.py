"""distance_kernel_roofline.fixed: ``distance_kernel_roofline`` in a cell whose
end-to-end metrics are the card's memory and set-up (PERF.md §2)."""
from perfbench.harness.spec import reader

read = reader("distance_kernel_roofline")
