"""Helper programs the port's bench spawns (``read_worker``)."""
