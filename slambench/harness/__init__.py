"""The benchmark's yardstick: finding a cell's files, the synthetic map,
the plain reference, the work counts and peaks, and the trace reader."""
