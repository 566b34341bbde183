"""The general machinery of the benchmark: the registry of cells, the
runner, spans, the trace reader and the guards."""
