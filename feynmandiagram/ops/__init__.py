"""Device compute path: lowering + batched leveled evaluation."""
from .lowering import lower, LoweredGraph, LevelPlan, SumPlan, ProdPlan, PowerPlan
from .evaluator import make_evaluator, evaluate_graphs
