"""Programs (CUDA graphs) built inside the window, over every replica:
`ReplicaEngine.programs()` counted at the window's start and end. Set-up
builds every one the traffic reaches, so a count above 0 is a build that
the window paid for."""


def read(ctx):
    return float(ctx["window"].captures)
