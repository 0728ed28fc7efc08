"""redispatch_per_batch.fixed: ``redispatch_per_batch`` in a cell whose
end-to-end metrics are the card's memory and set-up (PERF.md §2)."""
from perfbench.harness.spec import reader

read = reader("redispatch_per_batch")
