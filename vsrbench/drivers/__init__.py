"""General generators and drivers, one per kind of traffic. A traffic file
names its driver (`"driver"`); the driver reads the file's parameters and
the configuration's, builds the program, makes the inputs from the seed,
warms up, runs the window, reads the metrics and judges the outputs.
Each exposes `run(cell, args, device, t_process) -> (result, checks)`.
"""
