"""How a configuration is driven, one module a ``driver`` key: each defines a
``Driver`` (a subclass of ``base.Driver``) that builds the program's
pipeline over the ring, runs it for a number of blocks, and works the same
blocks out again with the plain reference."""
