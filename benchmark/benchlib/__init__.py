"""The benchmark's own library: the run's plumbing (`core`), the profiler's
reduction (`trace`), the table of peaks (`peaks`), the model's work counts
(`work`) and the weights made from the seed (`weights`). It imports nothing
of the program under test."""
