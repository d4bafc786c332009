"""One driver a kind of traffic (``train``, ``decode``): a function
``run(ctx)`` that sets up, measures the window and checks the outputs."""
