"""The traffic loops, one module each, found by the name a traffic file gives (:mod:`portbench.drive`)."""
