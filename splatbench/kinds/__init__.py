"""Traffic kinds: the code that drives the program for a traffic file's
`"kind"` (`splatbench/kinds/<kind>.py`, found by name). Each module gives

- `setup(ctx)`: the program's state made from the cell's inputs, every
  shape the window uses warmed up (the program's first calls included);
- `window(ctx, seconds)`: the measured window, returning {"metrics": its
  end-to-end metrics};
- `traced_window(ctx)`: a short window under the profiler, returning
  (profiler, host seconds, calls);
- `wind_down(ctx, traced)`: after the window and the memory reading, the
  calls attempted and failed counted (`ctx.attempted`, `ctx.failed`), an
  eager pass of the body profiled when traced (`ctx.eager`), and the
  program's state dropped;
- `numbers(ctx)`: the numbers `correct` compares, the program's outputs
  against the reference's;
- `control(ctx, fault=None)`: after `numbers`, the same numbers with the
  reference in bfloat16 put in the program's place (the control), with
  a fault planted in it, or in another sound float32 order ("reorder")
  (`splatbench/readings.py` reads them);
- `work(ctx)`: the work per traced call that the rooflines divide.

`ctx` is a `types.SimpleNamespace` with config, traffic, seed and device
set by the harness; a kind keeps its state on it, and `numbers` leaves
what it compared in `ctx.detail`, which the run prints.
"""
