"""Master-side services of the port (only the TensorBoard writer so
far)."""
