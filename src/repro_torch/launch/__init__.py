"""Launch tools of the port: process groups and meshes, the training CLI."""
