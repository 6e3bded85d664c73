"""Launch-time configuration of the port (backend settings)."""
