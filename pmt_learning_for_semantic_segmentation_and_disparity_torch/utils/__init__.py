"""Utilities of the port: the torch reference's checkpoint importer
(``torch_import``), dataset analysis (``analysis``), result panels and
heatmaps without matplotlib (``viz``), profiling (``profiling``: the
Chrome-trace exporter, and the program's spans and counters that a
profiler records)."""
