"""Host-side utilities of the port: the tracer and the profiler trace
(``timing``), checkpoint and resume (``checkpoint``), the experiment
config and the system registry (``config``) and plots and animations
(``viz``, which imports matplotlib only when it draws)."""
