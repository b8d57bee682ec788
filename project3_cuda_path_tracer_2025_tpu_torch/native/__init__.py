"""Native (C++) components built for the host: the BVH builder."""
