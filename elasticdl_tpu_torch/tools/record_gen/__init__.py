"""Raw data to RecordFiles: the port's copies of the root
``tools/record_gen/`` converters. For the same input and seed each
writes the same bytes as the JAX package's tool (the port's codec and
RecordFile writer are byte-equal to the JAX package's)."""
