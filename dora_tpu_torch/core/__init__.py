"""Constants of the dataflow framework the port's node needs."""
