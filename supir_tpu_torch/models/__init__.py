"""nn.Modules in NCHW whose state-dict keys are the reference torch keys."""
