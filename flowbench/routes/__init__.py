"""Routes: how a cell drives the program.  Each module holds one class
`Route(run)` with `RATE` (the end-to-end rate it measures), `setup()`,
`warmup()`, `window(window, tracer)`, `release()` and `check(window)` (the
compared numbers, after the window, against the plain reference).  A cell
names its route and the route's arguments in its workload file.

A route also says what one delivered frame's work is, for the readers that
count it (counts/): `reference_frame(device)`, a call of the plain
reference whose operations are one delivered frame's, and `aggregation()`,
GMA's aggregation per delivered frame as (rows, tokens, width,
iterations); and, where its path runs them, `lookups()` (K1's dense
lookups), `patch_lookups()` (K3's FlashCorr2 lookups) and `memory_reads()`
(K9's readout), whose tuples counts/ documents.  All follow from the
configuration, the traffic and the cell's shapes alone, never from the
program.  A route without one leaves its reader without a reading."""
