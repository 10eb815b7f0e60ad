"""The harness of the benchmark: finds a cell's configuration, traffic mix,
metrics and the pieces they name by name (``spec``), makes its inputs from
the seed (``data``), turns the program's results into answers and records
(``drive``), reduces a device trace (``trace``) and judges a seeded sample
of the answers against the plain reference (``check``).  ``peaks`` holds
the yardstick's constants."""
