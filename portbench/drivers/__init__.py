"""The drivers of traffic mixes: `drivers/<entry>.py` runs every mix
whose data file names that `entry`, through a module-level
`run(config, traffic, seed, seconds, trace, t_start, device)` that
returns the run's record for the metric readers, and a
`judge(record, config, limits)` that returns the numbers compared by the
check of `correct`, each as {"value", "limit"}."""
