from .planner import Plan, Spec, placements  # noqa: F401
