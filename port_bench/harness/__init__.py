"""The yardstick: cell lookup, traffic, window arithmetic, weights, tracing,
rooflines, model FLOPs, the import guard and the output comparison."""
