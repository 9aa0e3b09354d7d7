"""One driver per kind of system under test, found by a configuration's
``system`` key: it builds the program from the configuration, runs one
batch of the traffic through the program's own entry point and checks a
sample of what the window produced against the plain reference."""
