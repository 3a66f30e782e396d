"""Core HFEL path of the port: cost model, scenario generation, resource
allocation and edge association."""
