"""Image output and the render report."""
