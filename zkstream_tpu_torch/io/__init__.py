"""The runtime consumer of the tick decode."""

from .ingest import FleetIngest  # noqa: F401
