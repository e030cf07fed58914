"""Interactive viewer: browser-served live rendering (counterpart of
``boostmvsnerfs_tpu/interactive/``).

The reference ships a GLFW/imgui OpenGL viewer (``lib/interactive/``,
``lib/visualizers/enerf_interactive.py``) that renders into a native window.
Here, as in the JAX package, a small HTTP server (``server.py``) renders
frames on the card and streams JPEGs to a browser page with the same camera
interactions (drag-rotate, pan, zoom, WASD, camera-path autoplay) and render
options (level, pred or depth), so a headless GPU host serves it over a
forwarded port.
"""

from boostmvsnerfs_torch.interactive.camera import (  # noqa: F401
    InteractiveCamera,
    RenderOptions,
)
