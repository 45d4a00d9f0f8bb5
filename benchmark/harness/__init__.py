"""The benchmark harness: cells read from data (spec), the traffic
generator, the program's side (program), the modes (serve), the device
trace, and the assembly of a run's result (cellrun)."""
