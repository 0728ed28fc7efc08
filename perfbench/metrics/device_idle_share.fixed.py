"""device_idle_share.fixed: ``device_idle_share`` in a cell whose
end-to-end metrics are the card's memory and set-up (PERF.md §2)."""
from perfbench.harness.spec import reader

read = reader("device_idle_share")
