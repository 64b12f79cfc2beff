"""Evaluation: the eval CLI (non-iterative path), evaluate_full and its
pipelined variant, and the pose-AUC evaluators."""
