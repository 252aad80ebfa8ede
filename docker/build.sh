#!/bin/bash
# Build the ddlo image from the repo root (reference: docker/build.sh)
cd "$(dirname "$0")/.." && docker build --tag ddlo -f docker/Dockerfile "$@" .
