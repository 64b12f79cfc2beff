"""Evaluation: the eval CLI, the iterative match-pose loop, evaluate_full and
its pipelined variant, and the pose-AUC evaluators."""
