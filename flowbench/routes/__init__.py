"""Routes: how a cell drives the program.  Each module holds one class
`Route(run)` with `RATE` (the end-to-end rate it measures), `setup()`,
`warmup()`, `window(window, tracer)`, `release()` and `check(window)` (the
compared numbers, after the window, against the plain reference).  A cell
names its route and the route's arguments in its workload file."""
