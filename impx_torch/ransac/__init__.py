"""Relative pose on the device: the eight- and five-point solvers, RANSAC
with local optimisation, and the pose solvers (device and cv2 backends, and
the iterative loop's batched checkpoint solver); the fundamental-matrix
RANSAC of the FM bench's device backend."""
