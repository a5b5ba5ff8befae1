"""Process groups and device meshes (port of ``repro.launch``)."""
