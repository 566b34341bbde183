"""The workload drivers, one module per algorithm a mix names."""
