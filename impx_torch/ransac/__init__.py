"""Relative pose on the device: the eight-point solver, RANSAC with local
optimisation, and the pose solvers (device and cv2 backends)."""
