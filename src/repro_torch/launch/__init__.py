"""Entry points run from the command line (`train`, pointnet2 training) and the
serving replicas' device groups (`mesh`)."""
