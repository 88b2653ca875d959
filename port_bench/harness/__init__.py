"""The benchmark's harness: the cell's files, the run, the window's
statistics, the reading of the trace and the frozen roofline counts."""
