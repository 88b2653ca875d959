"""Camera, scene and the registered scenes."""
